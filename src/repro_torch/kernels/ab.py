"""A/B device times of the redesigned kernels against another tree's, the
launch choices of this tree's plans, and the rows probe.

    python3 src/repro_torch/kernels/ab.py --turns parent=DIR change=.

builds ``quant_matmul.cu``, ``flash_attention.cu``, ``decode_attention.cu``,
``ssd_scan.cu``, ``rglru_scan.cu`` and ``weight_transform.cu`` (with the
headers beside them) of each named tree into that tree's own ``build/``,
then times the kernels at the main path's shapes (the decode kernels also
at a 2048-row cache, ``weight_transform`` at its large leaves and at four
launch-bound small ones) in
turns, each tree in a process of its own, in the order A, B, B, A, so that
a drift of the card over the run shows up as a difference between the two
runs of one tree.  The decode kernels and the scans are also timed as
eager calls (``chip_smoke.call_ms``, host dispatch included: their extra
key ends in ``eager``).  The parent tree is made with ``git archive HEAD
src/repro_torch | tar -x -C DIR``.  Each tree is timed through its own
wrappers, so trees whose C entry points differ compare fine.  Prints one
JSON line per turn and a table of the means.

    python3 src/repro_torch/kernels/ab.py --sweep

times this tree's kernels at the launch choices their plans weigh, through
the C entry points: ``flash_attention`` with 1, 2 and 4 warps a block,
``quant_matmul`` with the slices in one block or in a block each, the two
decode kernels at split lengths 16 to 256 (at smollm-360m's, yi-9b's,
h2o-danube-3-4b's and recurrentgemma-2b's heads), ``ssd_scan`` at each
(chunk length L, dp columns a block) it is built for and ``rglru_scan`` at
(slices, slice length T) pairs.  The plan's own choice is checked
bit-equal to the wrapper, the others against the plain version within
phase 3's tolerances; ``weight_transform``'s dequant at its large leaves
over the grid (steps a thread), each launch bit-equal to the plain
version.

    python3 src/repro_torch/kernels/ab.py --probe DIR

runs the rows probe (:func:`probe_rows`) on the tree at DIR: one decode
step of recurrentgemma-2b and of mamba2-780m at full width, B = 4 against
B = 1, every op compared on the shared row.

Device time per call is ``chip_smoke.device_ms`` (a CUDA graph of 20
calls, replayed 5 times, timed with CUDA events).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
KEEP = ("quant_matmul.cu", "flash_attention.cu", "decode_attention.cu",
        "ssd_scan.cu", "rglru_scan.cu", "weight_transform.cu")
ENTRIES = ("repro_quant_matmul", "repro_flash_attention",
           "repro_decode_attention", "repro_decode_attention_paged",
           "repro_ssd_scan", "repro_rglru_scan", "repro_wt_dequant",
           "repro_wt_cast")

# (name, M, K, N): the distinct smollm-360m projections at a 4-slot decode
# step and a 128-token prefill, and the head at the decode step
QMM = [(f"qmm {m}x{k}x{n}", m, k, n) for m in (4, 128)
       for (k, n) in ((960, 960), (960, 320), (960, 2560), (2560, 960))]
QMM.append(("qmm 4x960x49152", 4, 960, 49152))
# (name, B, S, H, K, dh): the smollm and recurrentgemma prefills, a long one
FLASH = [("flash dh64 S128", 1, 128, 15, 5, 64),
         ("flash dh256 S128", 1, 128, 10, 1, 256),
         ("flash dh64 S1000", 1, 1000, 15, 5, 64),
         ("flash dh128 S70 B2", 2, 70, 8, 2, 128)]
# (name, H, K, dh, S_max, pos, page tokens or 0 for the slotted kernel): the
# smollm and recurrentgemma decode steps of phase 3, the paged 4-slot step,
# and both kernels at smollm heads over a 2048-row cache
DECODE = [("decode dh64 pos159", 15, 5, 64, 256, (159,), 0),
          ("decode dh256 pos159", 10, 1, 256, 256, (159,), 0),
          ("paged dh64 B4 pos<=159", 15, 5, 64, 256, (37, 80, 123, 159), 16),
          ("decode dh64 B4 S2048", 15, 5, 64, 2048, (2047, 1535, 1023, 511),
           0),
          ("paged dh64 B4 S2048", 15, 5, 64, 2048, (2047, 1535, 1023, 511),
           16)]
# the sweep's decode shapes at the head dims the main path does not take:
# yi-9b's heads (dh 128, rep 8) and h2o-danube-3-4b's (dh 120, rep 4)
DECODE_DIMS = [("decode dh128 pos159", 32, 4, 128, 256, (159,), 0),
               ("decode dh120 pos159", 32, 8, 120, 256, (159,), 0),
               ("decode dh128 B4 S2048", 32, 4, 128, 2048,
                (2047, 1535, 1023, 511), 0)]
# (name, b, nh, S, dp, N): mamba2-780m's SSD block at a 128-token prefill
SSD = [("ssd bf16 (1,48,128,64) N128", 1, 48, 128, 64, 128)]
# (name, B, S, W): recurrentgemma-2b's RG-LRU block at a 128-token prefill
RGLRU = [("rglru f32 (1,128,2560)", 1, 128, 2560)]
# (name, n, m, int8 or cast, output type): smollm-360m's tok leaf, vgg16's
# fc1, a mixtral-8x7b expert leaf (8 experts x 4096 rows), the f32 cast of
# the tok leaf; then launch-bound small leaves: smollm's (960, 960) and wq
# (14400, 64), mixtral's router (4096, 8), a vision head (4096, 1000)
WT = [("wt int8 (49152,960) f32", 49152, 960, True, "float32"),
      ("wt int8 (25088,4096) f32", 25088, 4096, True, "float32"),
      ("wt int8 (32768,14336) bf16", 32768, 14336, True, "bfloat16"),
      ("wt cast (49152,960) bf16", 49152, 960, False, "bfloat16")]
WT_SMALL = [("wt int8 (960,960) bf16", 960, 960, True, "bfloat16"),
            ("wt int8 (14400,64) bf16", 14400, 64, True, "bfloat16"),
            ("wt int8 (4096,8) bf16", 4096, 8, True, "bfloat16"),
            ("wt int8 (4096,1000) f32", 4096, 1000, True, "float32")]


def wt_inputs(dev, g, n, m, quantized):
    """(w, scale) of one WT shape: int8 with f32 scales, or f32 and None."""
    import torch
    if quantized:
        return (torch.randint(-127, 128, (n, m), generator=g, device=dev,
                              dtype=torch.int8),
                torch.rand(m, generator=g, device=dev) * 0.05)
    return torch.randn(n, m, generator=g, device=dev), None


def scan_inputs(dev, g, kind, *shape):
    """The path-shape inputs of a scan: (x, dt, A, B, C) for ssd_scan,
    (a, b) for rglru_scan, as phase 3 makes them."""
    import torch

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)
    if kind == "ssd":
        b, nh, S, dp, N = shape
        return (randn(b, nh, S, dp).to(torch.bfloat16),
                randn(b, nh, S).abs() * 0.1 + 0.01, -randn(nh).abs() - 0.1,
                randn(b, S, N) * 0.3, randn(b, S, N) * 0.3)
    B, S, W = shape
    return (torch.rand(B, S, W, generator=g, device=dev) * 0.5 + 0.5,
            randn(B, S, W))


def decode_inputs(chip_smoke, dev, g, H, K, dh, S_max, pos, pt):
    """bf16 inputs of one DECODE shape: (q, k, v, pos) for the slotted
    kernel, (q, k pages, v pages, tables, pos) for the paged one (pools
    shuffled, table entries past a row's pages on the scratch page)."""
    import torch
    B = len(pos)
    q = torch.randn(B, H, dh, generator=g, device=dev).to(torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    if not pt:
        kc, vc = (torch.randn(B, K, S_max, dh, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        return q, kc, vc, p
    tables = chip_smoke.page_tables(pos, pt, S_max // pt, 1, dev)
    kp, vp = (torch.randn(B * (S_max // pt) + 1, K, pt, dh, generator=g,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    return q, kp, vp, tables, p


def use_tree(tree: str):
    """Import ``tree``'s port, its build restricted to the kept kernels;
    returns (cuda_lib, flash_attention, quant_matmul, decode_attention,
    ssd_scan, rglru_scan, weight_transform, chip_smoke)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.kernels import ssd_scan as smod
    from repro_torch.kernels import weight_transform as wmod
    assert os.path.abspath(cuda_lib.__file__).startswith(
        os.path.abspath(tree)), cuda_lib.__file__
    cuda_lib._sources = lambda: sorted(
        p for p in cuda_lib.CSRC.glob("*.cu") if p.name in KEEP)
    cuda_lib.SIGNATURES = {k: v for k, v in cuda_lib.SIGNATURES.items()
                           if k in ENTRIES}
    sys.path.append(ROOT)
    import chip_smoke                 # after the tree's repro_torch
    return cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke


def one_tree(tree: str) -> dict:
    """Build and time one tree's kernels (in this process)."""
    import torch
    cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke = use_tree(tree)
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, m, k, n in QMM:
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(n, generator=g, device=dev) * 0.02 + 1e-3
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        out[name] = chip_smoke.device_ms(lambda: qmod.quant_matmul(x, w, s))
    for name, B, S, H, K, dh in FLASH:
        q, k, v = (torch.randn(B, S, h, dh, generator=g, device=dev)
                   .to(torch.bfloat16) for h in (H, K, K))
        out[name] = chip_smoke.device_ms(
            lambda: fmod.flash_attention(q, k, v, causal=True))
    for name, *shape in DECODE:
        args = decode_inputs(chip_smoke, dev, g, *shape)
        fn = dmod.decode_attention_paged if shape[-1] else \
            dmod.decode_attention
        out[name] = chip_smoke.device_ms(lambda: fn(*args))
        out[name + " eager"] = chip_smoke.call_ms(lambda: fn(*args))
    for name, *shape in SSD:
        args = scan_inputs(dev, g, "ssd", *shape)
        out[name] = chip_smoke.device_ms(lambda: smod.ssd_scan(*args))
        out[name + " eager"] = chip_smoke.call_ms(lambda: smod.ssd_scan(*args))
    for name, *shape in RGLRU:
        args = scan_inputs(dev, g, "rglru", *shape)
        out[name] = chip_smoke.device_ms(lambda: rmod.rglru_scan(*args))
        out[name + " eager"] = chip_smoke.call_ms(
            lambda: rmod.rglru_scan(*args))
    for name, n, m, quantized, dt in WT + WT_SMALL:
        w, s = wt_inputs(dev, g, n, m, quantized)
        dt = getattr(torch, dt)
        out[name] = chip_smoke.device_ms(
            lambda: wmod.weight_transform(w, s, out_dtype=dt))
        del w, s
    return {"build_s": build_s, "ms": out}


def sweep() -> None:
    """The launch choices of this tree's plans, timed at the path shapes
    (the results of each choice are checked bit-equal to the wrapper's)."""
    import torch
    cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke = \
        use_tree(ROOT)
    lib = cuda_lib.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_transform(wmod, chip_smoke, lib, dev, g)
    sweep_scans(cuda_lib, smod, rmod, chip_smoke, lib, dev, g)
    sweep_decode(cuda_lib, dmod, chip_smoke, lib, dev, g)
    for name, B, S, H, K, dh in FLASH[:3]:
        q, k, v = (torch.randn(B, S, h, dh, generator=g, device=dev)
                   .to(torch.bfloat16) for h in (H, K, K))
        want = fmod.flash_attention(q, k, v, causal=True)
        row = []
        for warps in (1, 2, 4):
            o = torch.empty_like(q)

            def call():
                cuda_lib.check(lib.repro_flash_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, H, K, S, S, dh, 1, *q.stride()[:3], *k.stride()[:3],
                    *v.stride()[:3], 1, 0, 1.0 / math.sqrt(dh), warps,
                    fmod.KEY_TILE[fmod.padded_dim(dh)], cuda_lib.stream_ptr(dev)),
                    "flash_attention")
            call()
            torch.cuda.synchronize()
            assert torch.equal(o, want), (name, warps)
            blocks = -(-S * (H // K) // (16 * warps)) * K * B
            row.append(f"{warps} warps ({blocks} blocks) "
                       f"{chip_smoke.device_ms(call):.5f} ms")
        print(f"{name}: " + ", ".join(row), flush=True)
    for name, m, k, n in QMM:
        p = qmod.plan(k, n)
        ls = qmod.launch_shape(p, m, n)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(n, generator=g, device=dev) * 0.02 + 1e-3
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        want = qmod.quant_matmul(x, w, s)
        row = []
        for groups in sorted({1, p.n_slices}):
            out = torch.empty_like(want)
            part = torch.empty((groups, m, n), device=dev)

            def call():
                cuda_lib.check(lib.repro_quant_matmul(
                    x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                    part.data_ptr(), m, k, n, 1, 1, p.slice_k, p.n_slices,
                    ls.bm, groups, cuda_lib.stream_ptr(dev)),
                    "quant_matmul")
            call()
            torch.cuda.synchronize()
            assert torch.equal(out, want), (name, groups)
            row.append(f"{'one block' if groups == 1 else 'a block each'}"
                       f"{'*' if groups == ls.groups else ''} "
                       f"{chip_smoke.device_ms(call):.5f} ms")
        print(f"{name} ({p.n_slices} slices of {p.slice_k}): "
              + ", ".join(row), flush=True)


def sweep_transform(wmod, chip_smoke, lib, dev, g) -> None:
    """weight_transform at its large leaves: the dequant's grid at the
    plan's columns a thread, from one pass to 256 steps a thread (about an
    SM-sized grid that loops; the cast: the plan's one tile a block); each
    launch bit-equal to plain.  Prints each variant's device ms and its
    share of the byte bound, the plan's own choice starred."""
    import torch
    for name, n, m, quantized, dt in WT:
        w, s = wt_inputs(dev, g, n, m, quantized)
        dt = getattr(torch, dt)
        want = wmod.plain(w, s, out_dtype=dt)
        nbytes = w.numel() * (w.element_size() + want.element_size()) + \
            (0 if s is None else s.numel() * 4)
        bound_ms = nbytes / chip_smoke.HBM_BPS * 1e3
        ptrs = (w.data_ptr(), None if s is None else s.data_ptr(),
                want.data_ptr())
        best = wmod.plan(n, m, dt, *ptrs)
        plans = [best]
        for steps in ((1, 2, 4, 8, 16, 64, 256) if quantized else ()):
            p = best._replace(grid=wmod.walk_grid(n, m // best.vec, steps))
            if p not in plans:
                plans.append(p)
        row = []
        o = torch.empty_like(want)
        for p in plans:
            def call():
                wmod.cuda_lib.check(wmod.launch(p, w, s, o, lib), name)
            o.zero_()
            call()
            torch.cuda.synchronize()
            assert torch.equal(o, want), (name, p)
            ms = chip_smoke.device_ms(call)
            row.append(f"{p.path} {p.grid} blocks{'*' if p == best else ''}"
                       f" {ms:.5f} ms {bound_ms / ms:.1%}")
        print(f"{name} [bound {bound_ms:.5f} ms]: " + ", ".join(row),
              flush=True)
        del w, s, want, o
        torch.cuda.empty_cache()


def sweep_scans(cuda_lib, smod, rmod, chip_smoke, lib, dev, g) -> None:
    """ssd_scan at each (chunk, cols) instance and rglru_scan at (slices,
    slice length) pairs, at the path shapes."""
    import torch
    for name, b, nh, S, dp, N in SSD:
        x, dt, A, B, C = scan_inputs(dev, g, "ssd", b, nh, S, dp, N)
        want = smod.ssd_scan(x, dt, A, B, C)
        ref = smod.plain(x, dt, A, B, C)
        best = smod.plan(dp, N, x.dtype)
        row = []
        for chunk, cols in smod.BF16_PLANS:
            y = torch.empty_like(x)

            def call():
                cuda_lib.check(lib.repro_ssd_scan(
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), None, y.data_ptr(), None, b, nh, S, dp, N,
                    1, chunk, cols, cuda_lib.stream_ptr(dev)), name)
            call()
            torch.cuda.synchronize()
            mine = (chunk, cols) == tuple(best)
            if mine:
                assert torch.equal(y, want), (name, chunk, cols)
            err = chip_smoke.rel_err(y, ref)
            assert err <= chip_smoke.BF16_ATOL, (name, chunk, cols, err)
            row.append(f"L={chunk} P={cols} ({-(-dp // cols) * nh * b} "
                       f"blocks){'*' if mine else ''} "
                       f"{chip_smoke.device_ms(call):.5f} ms")
        print(f"{name}: " + ", ".join(row), flush=True)
    for name, Bz, S, W in RGLRU:
        a, bb = scan_inputs(dev, g, "rglru", Bz, S, W)
        want = rmod.rglru_scan(a, bb)
        ref = rmod.plain(a, bb)
        best = rmod.plan()
        row = []
        for slices, slice_len in ((4, 16), (8, 8), (8, 16), (16, 8), (16, 4),
                                  (16, 16)):
            y = torch.empty_like(a)

            def call():
                cuda_lib.check(lib.repro_rglru_scan(
                    a.data_ptr(), bb.data_ptr(), y.data_ptr(), None, None, Bz,
                    S, W, S, 0, slices, slice_len, cuda_lib.stream_ptr(dev)),
                    name)
            call()
            torch.cuda.synchronize()
            mine = (slices, slice_len) == tuple(best)
            if mine:
                assert torch.equal(y, want), (name, slices, slice_len)
            err = chip_smoke.rel_err(y, ref)
            assert err <= chip_smoke.F32_ATOL, (name, slices, slice_len, err)
            row.append(f"{slices}x{slice_len}{'*' if mine else ''} "
                       f"{chip_smoke.device_ms(call):.5f} ms")
        print(f"{name} (slices x T): " + ", ".join(row), flush=True)


def sweep_decode(cuda_lib, dmod, chip_smoke, lib, dev, g) -> None:
    """Split lengths of the decode kernels at each DECODE shape."""
    import torch
    for name, H, K, dh, S_max, pos, pt in DECODE + DECODE_DIMS:
        args = decode_inputs(chip_smoke, dev, g, H, K, dh, S_max, pos, pt)
        q = args[0]
        B = q.shape[0]
        if pt:
            want = dmod.decode_attention_paged(*args)
            ref = dmod.plain_paged(*args)
            entry, extra = lib.repro_decode_attention_paged, (S_max // pt, pt)
        else:
            want = dmod.decode_attention(*args)
            ref = dmod.plain(*args)
            entry, extra = lib.repro_decode_attention, (S_max,)
        best = dmod.plan(K, H // K, dh)
        row = []
        for split_len in (16, 32, 64, 128, 256):
            o = torch.empty_like(q)
            part = torch.empty(B * K * -(-S_max // split_len) * (H // K)
                               * (dmod.padded_dim(dh) + 2), device=dev)

            def call():
                cuda_lib.check(entry(
                    *(t.data_ptr() for t in args), o.data_ptr(),
                    part.data_ptr(), B, H, K, *extra, dh, 1, 0,
                    1.0 / math.sqrt(dh), split_len,
                    cuda_lib.stream_ptr(dev)), name)
            call()
            torch.cuda.synchronize()
            if split_len == best:
                assert torch.equal(o, want), (name, split_len)
            err = (o.float() - ref.float()).abs().max().item()
            assert err <= chip_smoke.BF16_ATOL, (name, split_len, err)
            row.append(f"L={split_len}{'*' if split_len == best else ''} "
                       f"{chip_smoke.device_ms(call):.5f} ms")
        print(f"{name}: " + ", ".join(row), flush=True)


# ---------------------------------------------------------------------------
# the rows probe: which op of a decode step depends on the batch
# ---------------------------------------------------------------------------

PROBE_MAX_NUMEL = 1 << 24        # larger tensors (weights) are not compared


def _tensors(x) -> list:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    if isinstance(x, dict):
        return [t for e in x.values() for t in _tensors(e)]
    return []


def _site() -> str:
    """file:line of the innermost frame in the port's package (not this
    file): where the op was called from."""
    fr = sys._getframe(2)
    while fr is not None:
        f = fr.f_code.co_filename.replace(os.sep, "/")
        if "/repro_torch/" in f and not f.endswith("kernels/ab.py"):
            return f"{f[f.index('repro_torch/'):]}:{fr.f_lineno}"
        fr = fr.f_back
    return "?"


def _row(t4, t1, n: int):
    """The slot-0 row of a tensor of the n-row step that corresponds to
    t1 of the one-row step: t4 itself where the shapes agree (an input
    that is not batched), else t4 narrowed on the one axis that differs
    (n against 1, or n k against k for a batch-major flattening); None
    where no such axis exists."""
    if t4.shape == t1.shape:
        return t4
    if t4.dim() != t1.dim():
        return None
    axes = [d for d in range(t4.dim()) if t4.shape[d] != t1.shape[d]]
    if len(axes) != 1 or t4.shape[axes[0]] != n * t1.shape[axes[0]]:
        return None
    return t4.narrow(axes[0], 0, t1.shape[axes[0]])


def _bytes(t):
    """A tensor's bytes, from a dense copy (a narrowed row of any
    strides, size-1 axes included, views as bytes only so)."""
    import torch
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    return flat.copy_(t.reshape(-1)).view(torch.uint8)


def _same(a, b) -> bool:
    """Bit for bit (NaNs compare by their bits)."""
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bytes(a), _bytes(b))


class _Recorder:
    """Records every torch op that returns tensors (a
    ``TorchFunctionMode``), or, given the one-row step's records,
    compares each op of the n-row step with its twin on slot 0: an input
    row that differs (a kernel's output; nothing else can differ once
    every op's output is repaired) is reported and set to the one-row
    step's bits before the op runs, and an output row that differs is
    reported as a source and set likewise, so each op is judged on equal
    inputs and every op that depends on the batch shows."""

    UNINIT = ("empty", "empty_like", "empty_strided", "new_empty")

    def __init__(self, n: int = 1, ref=None):
        from torch.overrides import TorchFunctionMode
        rec = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = getattr(func, "__name__", str(func))
                ins = _tensors(list(args) + list(kwargs.values()))
                twin = rec.before(name, ins)
                out = func(*args, **kwargs)
                outs = _tensors(out)
                if outs:
                    rec.after(name, ins, outs, twin)
                return out

        self.mode = Mode()
        self.n, self.ref = n, ref
        self.records = []
        self.empties = {}        # data_ptr -> site of an uninitialised buffer
        self.first = None
        self.sources = {}        # where -> how many times
        self.compared = 0
        self.misaligned = None

    @staticmethod
    def _snap(ts):
        return [t.detach().clone() if t.numel() <= PROBE_MAX_NUMEL else None
                for t in ts]

    def _repair(self, ts4, ts1) -> list:
        """Indices of the tensors whose slot-0 row differs from the
        one-row step's; those rows are set to its bits."""
        bad = []
        for i, (t4, t1) in enumerate(zip(ts4, ts1)):
            if t1 is None or t4.numel() > PROBE_MAX_NUMEL:
                continue
            r = _row(t4, t1, self.n)
            if r is not None and not _same(r, t1):
                bad.append(i)
                r.copy_(t1)
        return bad

    def before(self, name, ins):
        """Recording: the op's inputs as they are before it runs (an
        in-place op changes them).  Comparing: the one-row twin of this op
        (None when misaligned), after repairing its input rows."""
        if self.ref is None:
            return self._snap(ins)
        if self.misaligned is not None:
            return None
        k = len(self.records)
        if k >= len(self.ref) or self.ref[k][0] != name:
            return None
        twin = self.ref[k]
        for i in self._repair(ins, twin[2]):
            src = self.empties.get(ins[i].data_ptr(), "an unrecorded write")
            self._source(f"input {i} of {name} at {_site()} (a kernel's "
                         f"output, allocated at {src})")
        return twin

    def after(self, name, ins, outs, twin):
        site = _site()
        uninit = name in self.UNINIT
        if uninit:
            for t in outs:
                self.empties[t.data_ptr()] = site
        if self.ref is None:
            self.records.append((name, site, twin,
                                 None if uninit else self._snap(outs)))
            return
        k = len(self.records)
        self.records.append(name)
        if self.misaligned is not None:
            return
        if twin is None:
            self.misaligned = (k, name, site)
            return
        self.compared += 1
        if uninit or not self._repair(outs, twin[3]):
            return
        where = (f"{name} at {site}: out "
                 f"{[tuple(t.shape) for t in outs]} {outs[0].dtype}")
        if self.first is None:
            self.first = where
        self._source(where)

    def _source(self, where: str):
        self.sources[where] = self.sources.get(where, 0) + 1


def probe_rows(model, params, prompts, *, cache_len: int = 256) -> dict:
    """One decode step of ``model`` at B = 1 and at B = len(prompts), the
    row of ``prompts[0]`` in slot 0 of both (each prompt prefilled at B = 1
    and its greedy first token fed, its cache copied into its slot as the
    scheduler's join does).  Every torch op of the two steps is recorded in
    order and compared on that row, bit for bit, each on repaired inputs
    (:class:`_Recorder`).  Returns ``first`` (the first op whose row
    differs, None if none does), ``sources`` (every op, and every kernel
    output, whose row differs on equal inputs: what depends on the batch),
    ``logits_equal`` (of a step without the probe's repairs) and the count
    of ops compared."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.serving.decode import _join_slot
    n = len(prompts)
    dev = model.device
    caches, toks, poss = [], [], []
    for p in prompts:
        c = model.init_cache(1, cache_len)
        tok = torch.as_tensor(p, device=dev)[None]
        lg, c = model.prefill(params, {"tokens": tok}, c)
        caches.append(c)
        toks.append(int(lg[0, -1].float().argmax()))
        poss.append(len(p))
    big = model.init_cache(n, cache_len)
    for i, c in enumerate(caches):
        _join_slot(big, c, i)
    tok = torch.tensor([[t] for t in toks], dtype=torch.int64, device=dev)
    pos = torch.tensor(poss, dtype=torch.int32, device=dev)
    tok1, pos1 = tok[:1], pos[:1]
    one = _Recorder()
    with torch.no_grad(), one.mode:
        lg1, _ = model.decode_step(params, caches[0], tok1, pos1)
    plain_big = tree_util.tree_map(torch.clone, big)
    with torch.no_grad():
        lgn, _ = model.decode_step(params, plain_big, tok, pos)
    many = _Recorder(n, one.records)
    with torch.no_grad(), many.mode:
        model.decode_step(params, big, tok, pos)
    return {"ops": len(one.records), "compared": many.compared,
            "first": many.first, "sources": many.sources,
            "misaligned": many.misaligned,
            "logits_equal": _same(lgn[:1], lg1)}


def probe(tree: str) -> None:
    """The rows probe on ``tree``'s port (its whole kernel library built in
    its own ``build/``): recurrentgemma-2b and mamba2-780m at full width,
    random weights (seed 0) cast to bf16, prompts of 128/37/64/100 tokens."""
    import numpy as np
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch import tree as tree_util
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    assert os.path.abspath(cuda_lib.__file__).startswith(
        os.path.abspath(tree)), cuda_lib.__file__
    cuda_lib.library()
    for arch in ("recurrentgemma-2b", "mamba2-780m"):
        cfg = get_config(arch)
        model = transformer.build(cfg)
        params = tree_util.tree_map(
            lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
            model.init(0))
        rng = np.random.default_rng(0)
        base = rng.integers(0, cfg.vocab_size, (128,))
        prompts = [base[:s] for s in (128, 37, 64, 100)]
        r = probe_rows(model, params, prompts)
        print(f"probe {arch} ({tree}): {json.dumps(r)}", flush=True)
        del model, params
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="time this tree (one turn)")
    ap.add_argument("--turns", nargs=2, metavar="NAME=DIR",
                    help="two trees, timed A, B, B, A")
    ap.add_argument("--sweep", action="store_true",
                    help="this tree's launch choices")
    ap.add_argument("--probe", metavar="DIR",
                    help="the rows probe on the tree at DIR")
    a = ap.parse_args()
    if a.probe:
        probe(a.probe)
        return 0
    if a.sweep:
        sweep()
        return 0
    if a.tree:
        print(json.dumps(one_tree(a.tree)))
        return 0
    trees = [t.split("=", 1) for t in a.turns]
    runs = {name: [] for name, _ in trees}
    for name, tree in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(name, json.dumps(res), flush=True)
        runs[name].append(res["ms"])
    (na, ra), (nb, rb) = runs.items()
    print(f"{'shape':30s} {na + ' ms':>20s} {nb + ' ms':>20s} {'ratio':>7s}")
    for key in ra[0]:
        a_ms = [r[key] for r in ra]
        b_ms = [r[key] for r in rb]
        ratio = (sum(b_ms) / len(b_ms)) / (sum(a_ms) / len(a_ms))
        print(f"{key:30s} {a_ms[0]:9.5f},{a_ms[1]:9.5f} "
              f"{b_ms[0]:9.5f},{b_ms[1]:9.5f} {ratio:7.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
