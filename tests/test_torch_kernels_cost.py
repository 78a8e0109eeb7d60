"""The registry kernels' meta branches and their ``cost`` functions.

On meta tensors every wrapper checks the call as its kernel would and
returns empty tensors of the kernel's output shapes, dtypes and layout,
launching nothing: held here against the plain version's outputs on CPU
inputs of the same shapes.  The autograd functions run forward and
backward on meta tensors that want a gradient.  Each ``cost`` gives, by
``max(bytes / 3.35e12, flops / peak)``, the bound PERF.md's table of
kernels states for its shape, to its 3 significant figures; and inside
``cost_analysis.counting`` a kernel call adds its cost and nothing of the
aten ops inside it."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dmod
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import flash_attention_bwd as bmod
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmod
from repro_torch.kernels import rglru_scan as rmod
from repro_torch.kernels import rmsnorm as nmod
from repro_torch.kernels import ssd_scan as smod
from repro_torch.kernels import weight_transform as wmod
from repro_torch.launch import cost_analysis

torch.set_num_threads(2)
BF, F32, I32 = torch.bfloat16, torch.float32, torch.int32
HBM_BPS = 3.35e12
PEAK = {BF: 989e12, F32: 67e12}


def _rand(seed, *shape, dtype=F32):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _cases():
    """(name, wrapper, positional args, kwargs): every registry kernel on
    CPU inputs, the variants whose outputs differ in number or shape."""
    q, k = _rand(0, 2, 9, 6, 16, dtype=BF), _rand(1, 2, 9, 3, 16, dtype=BF)
    v = _rand(2, 2, 9, 3, 16, dtype=BF)
    o, lse = fmod.plain(q, k, v, return_lse=True)
    qd = _rand(3, 2, 6, 16, dtype=BF)
    kc, vc = _rand(4, 2, 3, 20, 16, dtype=BF), _rand(5, 2, 3, 20, 16, dtype=BF)
    pos = torch.tensor([5, 19], dtype=I32)
    kp, vp = _rand(6, 7, 3, 4, 16, dtype=BF), _rand(7, 7, 3, 4, 16, dtype=BF)
    tables = torch.tensor([[0, 2, 4, 6, 1], [3, 5, 1, 0, 2]], dtype=I32)
    w8 = torch.from_numpy(np.random.default_rng(8).integers(
        -127, 128, (40, 24)).astype(np.int8))
    sc = torch.rand(24, generator=torch.Generator().manual_seed(9)) * 0.1
    xs = _rand(10, 2, 3, 9, 16, dtype=BF)
    dt = torch.rand(2, 3, 9, generator=torch.Generator().manual_seed(11))
    A = -torch.rand(3, generator=torch.Generator().manual_seed(12)) - 0.1
    Bs, Cs = _rand(13, 2, 9, 8), _rand(14, 2, 9, 8)
    h0 = _rand(15, 2, 3, 16, 8)
    a = torch.rand(2, 9, 12, generator=torch.Generator().manual_seed(16))
    b = _rand(17, 2, 9, 12)
    hr = _rand(18, 2, 12)
    xn, scn = _rand(19, 3, 5, 32, dtype=BF), _rand(20, 32)
    return [
        ("flash_attention", fmod.flash_attention, (q, k, v), {}),
        ("flash_attention lse window", fmod.flash_attention, (q, k, v),
         dict(window=4, return_lse=True)),
        ("flash_attention non-causal", fmod.flash_attention, (q, k, v),
         dict(causal=False)),
        ("flash_attention_bwd", bmod.flash_attention_bwd,
         (q, k, v, o, lse, _rand(21, 2, 9, 6, 16, dtype=BF)), {}),
        ("decode_attention", dmod.decode_attention, (qd, kc, vc, pos), {}),
        ("decode_attention_paged", dmod.decode_attention_paged,
         (qd, kp, vp, tables, pos), dict(window=8)),
        ("weight_transform dequant", wmod.weight_transform, (w8, sc),
         dict(out_dtype=F32)),
        ("weight_transform cast", wmod.weight_transform,
         (_rand(22, 40, 24),), {}),
        ("quant_matmul", qmod.quant_matmul, (_rand(23, 2, 3, 40, dtype=BF),
                                             w8, sc), {}),
        ("ssd_scan", smod.ssd_scan, (xs, dt, A, Bs, Cs), {}),
        ("ssd_scan state", smod.ssd_scan, (xs.float(), dt, A, Bs, Cs),
         dict(h0=h0, return_state=True)),
        ("ssd_scan_bwd", smod.ssd_scan_bwd,
         (xs, dt, A, Bs, Cs, _rand(24, 2, 3, 9, 16, dtype=BF)), {}),
        ("ssd_scan_bwd f32 h0", smod.ssd_scan_bwd,
         (xs.float(), dt, A, Bs, Cs, _rand(25, 2, 3, 9, 16)), dict(h0=h0)),
        ("rglru_scan", rmod.rglru_scan, (a, b), {}),
        ("rglru_scan state", rmod.rglru_scan, (a.to(BF), b.to(BF)),
         dict(h0=hr, return_state=True, n_valid=7)),
        ("rglru_scan_bwd", rmod.rglru_scan_bwd,
         (a, rmod.plain(a, b, h0=hr), _rand(26, 2, 9, 12)),
         dict(h0=hr, want_dh0=True)),
        ("rmsnorm", nmod.rmsnorm, (xn, scn), {}),
        ("rmsnorm_bwd", nmod.rmsnorm_bwd,
         (xn, scn, _rand(27, 3, 5, 32, dtype=BF)), {}),
    ]


CASES = {c[0]: c for c in _cases()}


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    return x


def _layout(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype,
                                    t.is_contiguous()) for t in outs]


@pytest.mark.parametrize("name", sorted(CASES))
def test_meta_branch_gives_the_kernels_outputs(name):
    """Shapes, dtypes and layout of the plain version's outputs (which the
    CPU branch lays out as the kernel does), on meta, no launch; the
    registry's cost of the call is a pair of counts."""
    ops.registry.reset_counts()
    _, fn, args, kwargs = CASES[name]
    want = fn(*args, **kwargs)
    got = fn(*map(_meta, args), **{k: _meta(v) for k, v in kwargs.items()})
    assert all(t is None or t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)))
    assert _layout(got) == _layout(want)
    assert set(ops.registry.dispatch_snapshot().values()) == {0}
    spec = ops.registry.spec(name.split()[0])
    flops, nbytes = spec.cost(*args, **kwargs)
    assert isinstance(flops, int) and isinstance(nbytes, int) and nbytes > 0


def test_meta_branch_refuses_what_the_kernel_refuses():
    m = torch.empty((1, 8, 4, 300), dtype=BF, device="meta")
    with pytest.raises(ValueError, match="head dim 300"):
        fmod.flash_attention(m, m, m)
    q = torch.empty((1, 20, 64), dtype=BF, device="meta")
    cache = torch.empty((1, 1, 32, 64), dtype=BF, device="meta")
    with pytest.raises(ValueError, match="rep 20"):
        dmod.decode_attention(q, cache, cache,
                              torch.empty(1, dtype=I32, device="meta"))
    x = torch.empty((1, 2, 8, 128), dtype=BF, device="meta")
    f = torch.empty((1, 2, 8), device="meta")
    bc = torch.empty((1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="head dim 128"):
        smod.ssd_scan_bwd(x, f, torch.empty(2, device="meta"), bc, bc, x)
    assert set(ops.registry.dispatch_snapshot().values()) == {0}


def _grads_on_meta(fn, *inputs):
    ins = [t.to("meta").requires_grad_(t.is_floating_point())
           for t in inputs]
    out = fn(*ins)
    wrt = [t for t in ins if t.requires_grad]
    return out, wrt, torch.autograd.grad(out.float().sum(), wrt)


def test_autograd_functions_run_forward_and_backward_on_meta():
    ops.registry.reset_counts()
    c = CASES
    for fn, inputs in (
            (lambda q, k, v: ops.flash_attention(q, k, v, window=4),
             c["flash_attention"][2]),
            (lambda x, s: ops.rmsnorm(x, s), c["rmsnorm"][2]),
            (lambda x, dt, A, B, C: ops.ssd_scan(x, dt, A, B, C, bc=4),
             c["ssd_scan"][2]),
            (lambda a, b: ops.rglru_scan(a, b, bc=4), c["rglru_scan"][2])):
        out, wrt, grads = _grads_on_meta(fn, *inputs)
        assert out.device.type == "meta"
        assert [(g.shape, g.dtype) for g in grads] == \
            [(t.shape, t.dtype) for t in wrt]
    assert set(ops.registry.dispatch_snapshot().values()) == {0}


def _bound_ms(cost, dtype):
    flops, nbytes = cost
    return max(nbytes / HBM_BPS, flops / PEAK[dtype]) * 1e3


def _m(*shape, dtype=BF):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rows_read(pos, H, K, dh, NP):
    """A paged step's work on this data: ``decode_attention``'s cost of
    each row over the pos + 1 positions it reads (``cost`` counts a whole
    cache), and the (B, NP) int32 page table read once."""
    flops = nbytes = 0
    for t in pos:
        f, b = dmod.cost(_m(1, H, dh), _m(1, K, t + 1, dh),
                         _m(1, K, t + 1, dh), _m(1, dtype=I32))
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes + 4 * len(pos) * NP


# (PERF.md's row, the kernel's cost at its timed shape, peak dtype, bound)
BOUNDS = [
    ("1: flash S 128", lambda: fmod.cost(_m(1, 128, 15, 64),
                                         _m(1, 128, 5, 64),
                                         _m(1, 128, 5, 64)), BF, 0.000196),
    ("1: flash dh 256", lambda: fmod.cost(_m(1, 128, 10, 256),
                                          _m(1, 128, 1, 256),
                                          _m(1, 128, 1, 256)), BF, 0.000430),
    ("1: flash S 1000", lambda: fmod.cost(_m(1, 1000, 15, 64),
                                          _m(1, 1000, 5, 64),
                                          _m(1, 1000, 5, 64)), BF, 0.00194),
    ("1: flash chunk", lambda: fmod.cost(_m(1, 2048, 15, 64),
                                         _m(1, 32768, 5, 64),
                                         _m(1, 32768, 5, 64)), BF, 0.252),
    ("2: decode, pos 159", lambda: dmod.cost(
        _m(1, 15, 64), _m(1, 5, 160, 64), _m(1, 5, 160, 64),
        _m(1, dtype=I32)), BF, 0.0000623),
    ("2: decode dh 256, pos 159", lambda: dmod.cost(
        _m(1, 10, 256), _m(1, 1, 160, 256), _m(1, 1, 160, 256),
        _m(1, dtype=I32)), BF, 0.0000520),
    ("4: paged, pos 37/80/123/159", lambda: _rows_read(
        (37, 80, 123, 159), 15, 5, 64, NP=16), BF, 0.000159),
    ("5: quant_matmul head", lambda: qmod.cost(
        _m(4, 960), _m(960, 49152, dtype=torch.int8),
        _m(49152, dtype=F32)), BF, 0.0143),
    ("6: ssd_scan (1,48,128,64)", lambda: smod.cost(
        _m(1, 48, 128, 64), _m(1, 48, 128, dtype=F32), _m(48, dtype=F32),
        _m(1, 128, 128, dtype=F32), _m(1, 128, 128, dtype=F32)), BF,
     0.000562),
    ("6: ssd_scan (8,48,512,64)", lambda: smod.cost(
        _m(8, 48, 512, 64), _m(8, 48, 512, dtype=F32), _m(48, dtype=F32),
        _m(8, 512, 128, dtype=F32), _m(8, 512, 128, dtype=F32)), BF, 0.0180),
    ("7: rglru_scan", lambda: rmod.cost(_m(1, 128, 2560, dtype=F32),
                                        _m(1, 128, 2560, dtype=F32)), F32,
     0.00117),
    ("3: weight_transform tok", lambda: wmod.cost(
        _m(49152, 960, dtype=torch.int8), _m(960, dtype=F32),
        out_dtype=F32), F32, 0.0704),
    ("rmsnorm decode", lambda: nmod.cost(_m(4, 1, 2560), _m(2560)), F32,
     0.0000138),
    ("rmsnorm training", lambda: nmod.cost(_m(8, 512, 960),
                                           _m(960, dtype=F32)), F32, 0.0047),
    ("flash_attention_bwd", lambda: bmod.cost(
        _m(8, 512, 15, 64), _m(8, 512, 5, 64), _m(8, 512, 5, 64),
        _m(8, 512, 15, 64), _m(8, 15, 512, dtype=F32),
        _m(8, 512, 15, 64)), BF, 0.0126),
    ("rmsnorm_bwd", lambda: nmod.cost_bwd(_m(8, 512, 960),
                                          _m(960, dtype=F32),
                                          _m(8, 512, 960)), F32, 0.00704),
    ("ssd_scan_bwd", lambda: smod.cost_bwd(
        _m(8, 48, 512, 64), _m(8, 48, 512, dtype=F32), _m(48, dtype=F32),
        _m(8, 512, 128, dtype=F32), _m(8, 512, 128, dtype=F32),
        _m(8, 48, 512, 64)), BF, 0.0255),
    ("rglru_scan_bwd", lambda: rmod.cost_bwd(
        *(_m(8, 512, 2560, dtype=F32) for _ in range(3))), F32, 0.0626),
]


@pytest.mark.parametrize("row,cost,dtype,want", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_gives_the_perf_table_bound(row, cost, dtype, want):
    assert float(f"{_bound_ms(cost(), dtype):.3g}") == want


def test_paged_cost_is_the_slotted_cost_over_the_tables_span():
    """``cost_paged`` counts each row over its table's NP * pt positions
    (the window's where one is set), as ``cost`` over a cache of that
    many slots, and the table read once besides."""
    q, pos, tables = _m(4, 15, 64), _m(4, dtype=I32), _m(4, 10, dtype=I32)
    pages = _m(65, 5, 16, 64)
    for window, keys in ((0, 160), (100, 100), (400, 160)):
        f, b = dmod.cost(q, _m(4, 5, keys, 64), _m(4, 5, keys, 64), pos)
        assert dmod.cost_paged(q, pages, pages, tables, pos,
                               window=window) == (f, b + 4 * 40)


def test_visible_pairs_count_the_mask():
    for S, T in ((1, 1), (5, 5), (7, 19), (16, 64), (33, 40)):
        for causal in (True, False):
            for window in (0, 1, 3, 8, 100):
                want = int(fmod.visible(S, T, causal, window, "cpu").sum())
                assert fmod.visible_pairs(S, T, causal, window) == want


def test_counting_adds_a_kernels_cost_and_none_of_its_aten_ops():
    x, sc = CASES["rmsnorm"][2]
    with cost_analysis.counting() as tally:
        y = ops.rmsnorm(x, sc)
    assert tally.kernels == {"rmsnorm": 1}
    assert (tally.flops, tally.bytes) == nmod.cost(x, sc)
    w = _rand(30, 32, 7, dtype=BF)
    with cost_analysis.counting() as tally:
        y @ w
    assert tally.kernels == {} and tally.flops == 2 * 15 * 32 * 7
    assert tally.bytes == 2 * (y.numel() + w.numel() + 15 * 7)


def test_meta_branches_allocate_the_kernels_scratch():
    """quant_matmul's split partials and ssd_scan_bwd's saved states are
    live on meta as on the card (the peak the dry run reads)."""
    x = _m(2, 960)
    w, s = _m(960, 4096, dtype=torch.int8), _m(4096, dtype=F32)
    groups = qmod.launch_shape(qmod.plan(960, 4096), 2, 4096).groups
    assert groups > 1
    with cost_analysis.counting() as tally:
        qmod.quant_matmul(x, w, s)
    assert tally.peak_live_bytes >= groups * 2 * 4096 * 4 + 2 * 4096 * 2
    args = [_m(1, 2, 256, 64), _m(1, 2, 256, dtype=F32), _m(2, dtype=F32),
            _m(1, 256, 64, dtype=F32), _m(1, 256, 64, dtype=F32),
            _m(1, 2, 256, 64)]
    p = smod.plan_bwd(64, 64, BF)
    scratch = sum(t.numel() * 4 for t in
                  smod.bwd_scratch(1, 2, 256, 64, 64, p, "meta"))
    with cost_analysis.counting() as tally:
        smod.ssd_scan_bwd(*args)
    assert tally.peak_live_bytes >= scratch
    assert set(ops.registry.dispatch_snapshot().values()) == {0}
