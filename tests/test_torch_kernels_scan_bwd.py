"""The scans' backward kernels' plain versions and the autograd wiring
around them, on the CPU: ``ssd_scan.plain_bwd`` against ``jax.vjp`` of the
reference's ``_xla_ssd`` (several chunks, ``bc`` below S, a chunk the whole
S) and against torch autograd of the sequential oracle; ``ops.ssd_scan``'s
gradient at an S the chunk does not divide against ``jax.vjp`` of the
reference's ``ops.ssd_scan`` (which pads the same way); likewise
``rglru_scan.plain_bwd`` against ``_xla_rglru``, also from an initial state
h0 (the reference has none: its first input carries ``a_0 h0``); the
autograd functions only where a gradient is wanted; a failing launch
raises; and the guard that makes a forward kernel without a backward raise
where a CUDA input wants a gradient.  The JAX side runs with
``REPRO_PALLAS=ref``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ops import _xla_rglru, _xla_ssd
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels import rglru_scan as rmod
from repro_torch.kernels import ssd_scan as smod
from torch_testlib import elsewhere

torch.set_num_threads(2)
TOL = 1e-4          # of each gradient's max |g|, f32 against f32


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return np.abs(np.asarray(a, np.float32) - b).max() / max(
        np.abs(b).max(), 1e-30)


def ssd_inputs(r, b, nh, S, dp, N):
    """x, dt > 0, A < 0, B, C and a cotangent dy, as numpy f32."""
    return (r.standard_normal((b, nh, S, dp)).astype(np.float32),
            (np.abs(r.standard_normal((b, nh, S))) * 0.3 + 0.02)
            .astype(np.float32),
            (-np.abs(r.standard_normal(nh)) - 0.2).astype(np.float32),
            (r.standard_normal((b, S, N)) * 0.5).astype(np.float32),
            (r.standard_normal((b, S, N)) * 0.5).astype(np.float32),
            r.standard_normal((b, nh, S, dp)).astype(np.float32))


# (b, nh, S, dp, N, bc): chunks of 16 over 32 steps, one chunk the whole S,
# mamba2-780m smoke's heads
SSD = [(2, 3, 32, 8, 5, 16), (1, 2, 24, 16, 16, 24), (2, 8, 48, 16, 16, 16)]


@pytest.mark.parametrize("case", SSD, ids=lambda c: "-".join(map(str, c)))
def test_ssd_plain_bwd_vs_jax(case):
    b, nh, S, dp, N, bc = case
    r = np.random.default_rng(sum(case))
    x, dt, A, B, C, dy = ssd_inputs(r, b, nh, S, dp, N)
    got = smod.plain_bwd(*(torch.from_numpy(t) for t in (x, dt, A, B, C,
                                                          dy)))
    _, vjp = jax.vjp(lambda *a: _xla_ssd(*a, bc=bc),
                     *(jnp.asarray(t) for t in (x, dt, A, B, C)))
    want = vjp(jnp.asarray(dy))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) <= TOL, name
    # and against torch autograd of the sequential oracle
    ins = [torch.from_numpy(t).requires_grad_() for t in (x, dt, A, B, C)]
    auto = torch.autograd.grad(ref.ssd(*ins), ins, torch.from_numpy(dy))
    for g, w in zip(got, auto):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


def test_ssd_ops_gradient_padded_vs_jax():
    """S = 21 over chunks of 8: the port pads to 24 and slices, through
    ``SSDScan``; the reference's ``ops.ssd_scan`` pads the same way."""
    r = np.random.default_rng(11)
    x, dt, A, B, C, dy = ssd_inputs(r, 2, 3, 21, 8, 6)
    ins = [torch.from_numpy(t).requires_grad_() for t in (x, dt, A, B, C)]
    got = torch.autograd.grad(ops.ssd_scan(*ins, bc=8), ins,
                              torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda *a: jops.ssd_scan(*a, bc=8),
                     *(jnp.asarray(t) for t in (x, dt, A, B, C)))
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        assert tuple(g.shape) == w.shape and _rel(g.numpy(), w) <= TOL


def rglru_inputs(r, B, S, W):
    return ((r.random((B, S, W)) * 0.5 + 0.45).astype(np.float32),
            r.standard_normal((B, S, W)).astype(np.float32),
            r.standard_normal((B, W)).astype(np.float32),
            r.standard_normal((B, S, W)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_plain_bwd_vs_jax(with_h0):
    """dh0 against the reference written with h0 folded into its first
    input (``b_0 + a_0 h0``), which is what the recurrence from h0 is."""
    r = np.random.default_rng(3 + with_h0)
    a, b, h0, g = rglru_inputs(r, 2, 37, 12)
    ta, tb, th = (torch.from_numpy(t) for t in (a, b, h0))
    h0_t = th if with_h0 else None
    y = ref.rglru(ta, tb, h0=h0_t)
    da, db, dh0 = rmod.plain_bwd(ta, y, torch.from_numpy(g), h0=h0_t)

    def jfn(a_, b_, h_):
        first = b_[:, :1] + (a_[:, :1] * h_[:, None] if with_h0 else 0.0)
        return _xla_rglru(a_, jnp.concatenate([first, b_[:, 1:]], axis=1))
    _, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (a, b, h0)))
    wa, wb, wh = vjp(jnp.asarray(g))
    assert _rel(da.numpy(), wa) <= TOL and _rel(db.numpy(), wb) <= TOL
    if with_h0:
        assert _rel(dh0.numpy(), wh) <= TOL
    else:
        assert dh0 is None
    # through ops at an S the chunk does not divide: padded, sliced
    ins = [torch.from_numpy(t).requires_grad_() for t in (a, b, h0)]
    got = torch.autograd.grad(
        ops.rglru_scan(ins[0], ins[1], bc=8,
                       h0=ins[2] if with_h0 else None),
        ins[:3] if with_h0 else ins[:2], torch.from_numpy(g))
    for u, w in zip(got, (wa, wb, wh)):
        assert _rel(u.numpy(), w) <= TOL


def test_autograd_functions_only_where_a_gradient_is_wanted(monkeypatch):
    """Serving calls (no gradient wanted, or under no_grad) run the scans
    as they always have; a call that wants a gradient takes the autograd
    function; asking for the final state there raises, as does a gradient
    for ssd_scan's h0."""
    r = np.random.default_rng(5)
    x, dt, A, B, C, _ = (torch.from_numpy(t) for t in
                         ssd_inputs(r, 1, 2, 10, 4, 3))
    a, b, h0, _ = (torch.from_numpy(t) for t in rglru_inputs(r, 1, 10, 4))
    calls = []
    for mod, name in ((smod, "SSDScan"), (rmod, "RGLRUScan")):
        fn = getattr(mod, name)
        monkeypatch.setattr(fn, "apply", (lambda f, n: lambda *args: (
            calls.append(n), f(*args))[1])(fn.apply, name))
    y_s, hs = ops.ssd_scan(x, dt, A, B, C, bc=4, return_state=True)
    y_r = ops.rglru_scan(a, b, bc=4)
    with torch.no_grad():
        ops.ssd_scan(x.clone().requires_grad_(), dt, A, B, C, bc=4)
        ops.rglru_scan(a.clone().requires_grad_(), b, bc=4)
    assert calls == []
    xg, ag = x.clone().requires_grad_(), a.clone().requires_grad_()
    assert torch.equal(ops.ssd_scan(xg, dt, A, B, C, bc=4), y_s)
    assert torch.equal(ops.rglru_scan(ag, b, bc=4), y_r)
    assert calls == ["SSDScan", "RGLRUScan"]
    with pytest.raises(ValueError, match="final state"):
        ops.ssd_scan(xg, dt, A, B, C, bc=4, return_state=True)
    with pytest.raises(ValueError, match="final state"):
        ops.rglru_scan(ag, b, bc=4, return_state=True)
    with pytest.raises(NotImplementedError, match="h0"):
        ops.ssd_scan(xg, dt, A, B, C, h0=hs.clone().requires_grad_(),
                     bc=4).sum().backward()
    ops.registry.reset_counts()
    ops.rglru_scan(ag, b, h0=h0.clone().requires_grad_(), bc=4).sum() \
        .backward()
    assert ag.grad is not None
    assert sum(ops.registry.dispatch_snapshot().values()) == 0    # CPU


class _FailingLib:
    def __getattr__(self, name):
        return lambda *a: 700            # cudaErrorIllegalAddress


def test_failing_launch_raises(monkeypatch):
    """A launch the library refuses raises in each backward's launch step
    and counts nothing; a device other than CPU or CUDA is refused."""
    import contextlib
    monkeypatch.setattr(cuda_lib, "library", lambda: _FailingLib())
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    ops.registry.reset_counts()
    x, y = torch.zeros(1, 2, 8, 4), torch.zeros(1, 2, 8)
    B, h = torch.zeros(1, 8, 3), torch.zeros(1, 2, 8, 3)
    with pytest.raises(RuntimeError, match="ssd_scan_bwd: CUDA launch"):
        smod._launch_bwd(x, y, y[0, 0, :2], B, B, None, x, x.clone(),
                         y.clone(), y[0, 0, :2].clone(), B.clone(),
                         B.clone(), h, h.clone(), y[:, :, 0].clone(),
                         rows=16)
    a = torch.zeros(2, 8, 4)
    with pytest.raises(RuntimeError, match="rglru_scan_bwd: CUDA launch"):
        rmod._launch_bwd(a, a, a, None, a.clone(), a.clone(), None)
    snap = ops.registry.dispatch_snapshot()
    assert snap["ssd_scan_bwd"] == 0 and snap["rglru_scan_bwd"] == 0
    t = elsewhere(1, 2, 8, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        smod.ssd_scan_bwd(t, elsewhere(1, 2, 8), elsewhere(2),
                          elsewhere(2, 8, 4), elsewhere(2, 8, 4), t)
    r = elsewhere(2, 8, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        rmod.rglru_scan_bwd(r, r, r)


def test_forward_only_kernels_raise_where_a_gradient_is_wanted(monkeypatch):
    """The entries of the forward kernels that have no backward
    (``decode_attention``, ``decode_attention_paged``,
    ``weight_transform``, ``quant_matmul``) raise on a card tensor that
    wants a gradient (the device check patched to say the tensors lie on
    the card), and run as always under no_grad or with no gradient
    wanted."""
    r = np.random.default_rng(9)
    q = torch.from_numpy(r.standard_normal((2, 4, 8)).astype(np.float32))
    kc = torch.from_numpy(r.standard_normal((2, 2, 16, 8)).astype(
        np.float32))
    pos = torch.tensor([3, 9])
    pages = kc.reshape(4, 2, 8, 8)
    tables = torch.tensor([[0, 1], [2, 3]])
    w8 = torch.from_numpy(r.integers(-127, 128, (8, 6)).astype(np.int8))
    sc = torch.from_numpy(r.random(6).astype(np.float32))
    wf = torch.from_numpy(r.standard_normal((8, 6)).astype(np.float32))
    calls = {
        "decode_attention": lambda t: ops.decode_attention(t, kc, kc, pos),
        "decode_attention_paged": lambda t: ops.decode_attention_paged(
            t, pages, pages, tables, pos),
        "weight_transform": lambda t: ops.weight_transform(
            wf, t[0, :1, :6].reshape(6), out_dtype=torch.float32),
        "quant_matmul": lambda t: ops.quant_matmul(t[0], w8, sc)}
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    for name, call in calls.items():
        want = call(q)                           # no gradient wanted
        with torch.no_grad():
            assert torch.equal(call(q.clone().requires_grad_()), want)
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                               f"backward"):
            call(q.clone().requires_grad_())
    monkeypatch.setattr(ops, "_on_card", lambda t: t.device.type == "cuda")
    for call in calls.values():                  # the CPU's plain versions
        assert call(q.clone().requires_grad_()).requires_grad


def test_registry_holds_the_scan_backwards():
    for name, mod, source, line in (
            ("ssd_scan_bwd", smod, "ssd_scan_bwd.cu", "ops.py:411"),
            ("rglru_scan_bwd", rmod, "rglru_scan.cu", "ops.py:509")):
        spec = ops.registry.spec(name)
        assert spec.plain is mod.plain_bwd and spec.source.endswith(source)
        assert spec.counter is mod.bwd_launches
        assert spec.replaces == f"src/repro/kernels/{line}"
    assert [smod.bwd_rows(d) for d in (1, 16, 17, 32, 64)] == \
        [16, 16, 32, 32, 64]
    with pytest.raises(ValueError):
        smod.bwd_rows(65)
    sig = cuda_lib.SIGNATURES
    assert len(sig["repro_ssd_scan_bwd"]) == 23
    assert len(sig["repro_rglru_scan_bwd"]) == 11
