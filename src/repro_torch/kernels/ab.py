"""A/B device times of the redesigned kernels against another tree's, the
launch choices of this tree's plans, and the rows probe.

    python3 src/repro_torch/kernels/ab.py --turns parent=DIR change=.

builds ``quant_matmul.cu``, ``flash_attention.cu``, ``decode_attention.cu``,
``ssd_scan.cu``, ``rglru_scan.cu``, ``weight_transform.cu``,
``flash_attention_bwd.cu``, ``rmsnorm.cu`` and ``ssd_scan_bwd.cu`` (with
the headers beside them; a tree without a source skips its kernels) of
each named tree into that tree's own ``build/``, then times the
kernels at the main path's shapes (the decode kernels also at a 2048-row
cache, ``weight_transform`` at its large leaves and at four launch-bound
small ones, ``flash_attention_bwd`` at smollm-360m's training shape and at
h2o-danube-3-4b's heads with its window, ``rmsnorm`` at the training rows
and a decode step's, ``rmsnorm_bwd`` at the training rows, ``ssd_scan``
and the scans' backwards ``ssd_scan_bwd`` and ``rglru_scan_bwd`` at
mamba2-780m's and recurrentgemma-2b's training shapes, also as eager
calls) in
turns, each tree in a process of its own, in the order A, B, B, A, so that
a drift of the card over the run shows up as a difference between the two
runs of one tree.  The decode kernels and the scans are also timed as
eager calls (``chip_smoke.call_ms``, host dispatch included: their extra
key ends in ``eager``).  The parent tree is made with ``git archive HEAD
src/repro_torch | tar -x -C DIR``.  Each tree is timed through its own
wrappers, so trees whose C entry points differ compare fine.  Each turn
also hashes ``flash_attention_bwd``'s f32 results at phase 27's f32 cases
(inputs from one seed): they must be the same bits in every turn of both
trees, else the run fails; ``rmsnorm_bwd``'s f32 results at ``NORM_F32``
(one seed), which must be the same bits in the turns of each tree (the
trees may sum dscale in different orders); and the scans' backwards' f32
results at ``SCAN_BWD_F32``, which must be the same bits in every turn of
both trees (the bf16 ``ssd_scan_bwd`` was redesigned, its f32 design
kept).  Prints one JSON
line per turn and a table of the means over the shapes both trees have.

    python3 src/repro_torch/kernels/ab.py --sweep

times this tree's kernels at the launch choices their plans weigh, through
the C entry points: ``flash_attention`` with 1, 2 and 4 warps a block,
``quant_matmul`` with the slices in one block or in a block each, the two
decode kernels at split lengths 16 to 256 (at smollm-360m's, yi-9b's,
h2o-danube-3-4b's and recurrentgemma-2b's heads), ``ssd_scan`` at each
(chunk length L, dp columns a block) it is built for and ``rglru_scan`` at
(slices, slice length T) pairs, ``flash_attention_bwd`` at each (kv
rows, q keys) pair of tiles its padded dim is built at (``plan_bwd``'s
and ``ALT_TILES``), ``rmsnorm`` at each (threads a row, teams a block,
rows a team) and ``rmsnorm_bwd`` at each (threads a row, rows a team: its
block rule), with phase 27's f32-x / bf16-scale case replayed to show
how each launch shape's dscale rounds (:func:`norm_rounding`);
``ssd_scan_bwd`` at each of its bf16 instances (Q, L, P) with its three
kernels' times and both scan backwards beside their plain versions and
bounds (:func:`sweep_scan_bwd`).  The
plan's own choice is checked bit-equal to the wrapper,
the others against the plain version within phase 3's (phase 27's for
the backwards) tolerances; ``weight_transform``'s dequant at its large
leaves over the grid (steps a thread), each launch bit-equal to the plain
version.

    python3 src/repro_torch/kernels/ab.py --ablate

times ``ssd_scan_bwd`` (bf16) at mamba2-780m's training shape in copies of
this tree's port under ``build/ablate/``, each with one part of the bf16
kernels' work taken out of ``csrc/ssd_scan_bwd.cu`` (:data:`ABLATIONS`;
the results are wrong, the device times show what that part costs),
beside the unchanged source: the call by graph replay and each kernel by
torch.profiler.  The copies are built at once, one process each, then
timed one after another.

    python3 src/repro_torch/kernels/ab.py --probe DIR

runs the rows probe (:func:`probe_rows`) on the tree at DIR: one decode
step of recurrentgemma-2b and of mamba2-780m at full width, B = 4 against
B = 1, every op compared on the shared row.

Device time per call is ``chip_smoke.device_ms`` (a CUDA graph of 20
calls, replayed 5 times, timed with CUDA events).  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))
KEEP = ("quant_matmul.cu", "flash_attention.cu", "decode_attention.cu",
        "ssd_scan.cu", "rglru_scan.cu", "weight_transform.cu",
        "flash_attention_bwd.cu", "rmsnorm.cu", "ssd_scan_bwd.cu")
ENTRIES = ("repro_quant_matmul", "repro_flash_attention",
           "repro_decode_attention", "repro_decode_attention_paged",
           "repro_ssd_scan", "repro_rglru_scan", "repro_wt_dequant",
           "repro_wt_cast", "repro_flash_attention_bwd", "repro_rmsnorm",
           "repro_rmsnorm_bwd", "repro_ssd_scan_bwd", "repro_ssd_scan_bwd_tc",
           "repro_rglru_scan_bwd")

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
# (name, B, S, H, K, dh, window), causal bf16: smollm-360m's training shape
# and h2o-danube-3-4b's heads at S 4352 with its 4096 window
BWD = [("bwd (8,512,15/5,64)", 8, 512, 15, 5, 64, 0),
       ("bwd (1,4352,32/8,120) w4096", 1, 4352, 32, 8, 120, 4096)]
# phase 27's f32 cases (B, S, H, K, dh, causal, window), hashed every turn
BWD_F32 = [(2, 128, 15, 5, 64, True, 0), (2, 100, 6, 2, 20, True, 0),
           (1, 96, 16, 16, 80, False, 0), (1, 77, 4, 2, 80, False, 16),
           (2, 200, 8, 2, 64, True, 48), (1, 128, 10, 1, 256, True, 0)]
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
# and at its training shape (batch 8, seq 512)
SSD = [("ssd bf16 (1,48,128,64) N128", 1, 48, 128, 64, 128),
       ("ssd bf16 (8,48,512,64) N128", 8, 48, 512, 64, 128)]
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
# (name, x shape, x dtype, scale dtype): rmsnorm at smollm-360m's training
# rows and at recurrentgemma-2b's decode step; its backward at the former
NORM = [("rmsnorm (8,512,960) f32 scale", (8, 512, 960), "bfloat16",
         "float32"),
        ("rmsnorm (4,1,2560) bf16 scale", (4, 1, 2560), "bfloat16",
         "bfloat16")]
NORM_BWD = [("rmsnorm_bwd (8,512,960) f32 scale", (8, 512, 960), "bfloat16",
             "float32")]
# rmsnorm_bwd's f32 cases hashed every turn: phase 27's widths
NORM_F32 = [(8, 512, 960), (3, 7, 3072), (2, 3, 20), (5, 8192)]
# the scans' backwards at the training shapes (batch 8, seq 512): (name,
# b, nh, S, dp, N) bf16 x for ssd_scan_bwd, (name, B, S, W) f32 for
# rglru_scan_bwd; their f32 cases hashed every turn
SSD_BWD = [("ssd_bwd bf16 (8,48,512,64) N128", 8, 48, 512, 64, 128)]
RGLRU_BWD = [("rglru_bwd f32 (8,512,2560)", 8, 512, 2560)]
SCAN_BWD_F32 = [("ssd", 2, 8, 300, 64, 128), ("ssd", 2, 4, 77, 16, 16),
                ("rglru", 2, 300, 2560)]
# ssd_scan_bwd.cu's bf16 kernels with one part of their work taken out:
# (name, [(text, its replacement, times it occurs)]).  A condition on dp
# (positive at run time, unknown to the compiler) skips the work and keeps
# the code around it as it was.
ABLATIONS = [
    ("walk: no dx", [
        ("    if (rev) {\n      // ---- dx of this warp's steps",
         "    if (rev && dp < 0) {\n      // ---- dx of this warp's steps", 1)]),
    ("walk: no B, C loads", [
        ("        if (j < nv && cc < N) {\n"
         "          const long long o = (long long)(t0 + j) * N + cc;\n"
         "          if (nvec) {",
         "        if (j < nv && cc < N && dp < 0) {\n"
         "          const long long o = (long long)(t0 + j) * N + cc;\n"
         "          if (nvec) {", 1)]),
    ("walk: no B, C pieces", [
        ("        if (!rev) {\n"
         "          const float w = expf(cum_last - cum[j]) * dts[j];",
         "        if (dp < 0) {\n"
         "        } else if (b4.x == 1.2345f && c4.y == 1.2345f) {\n"
         "          R0[so4] = __float2bfloat16_rn(b4.z + c4.w);\n"
         "        } else if (dp < 0 && !rev) {\n"
         "          const float w = expf(cum_last - cum[j]) * dts[j];", 1),
        ("        } else {\n          const float w = expf(cum[j]);",
         "        } else if (dp < 0) {\n          const float w = expf(cum[j]);",
         1)]),
    ("walk: no state products", [
        ("              mma::mma_bf16(st[m][2 * np + q], xa, v[pc][2 * q],\n"
         "                            v[pc][2 * q + 1]);",
         "              st[m][2 * np + q][0] +=\n"
         "                  __uint_as_float(xa[0] ^ v[pc][2 * q]);", 1)]),
    ("heads: no intra products", [
        ("if (jt > rt) continue;", "if (jt > rt || dp > 0) continue;", 1),
        ("if (kt < rt) continue;", "if (kt < rt || dp > 0) continue;", 1)]),
    ("heads: no inter products", [
        ("            for (int pc = 0; pc < 3; ++pc) {\n"
         "              uint32_t hb[4];",
         "            for (int pc = 0; pc < 3 * (dp < 0); ++pc) {\n"
         "              uint32_t hb[4];", 1),
        ("            for (int pc = 0; pc < 3; ++pc) {\n"
         "              uint32_t gb[4];",
         "            for (int pc = 0; pc < 3 * (dp < 0); ++pc) {\n"
         "              uint32_t gb[4];", 1)]),
    ("heads: intra hi.hi only", [
        ("  mma::mma_bf16(c0, a[0], b1[0], b1[1]);     // hi.mid\n"
         "  mma::mma_bf16(c1, a[0], b1[2], b1[3]);\n"
         "  mma::mma_bf16(c0, a[1], b0[0], b0[1]);     // mid.hi\n"
         "  mma::mma_bf16(c1, a[1], b0[2], b0[3]);\n"
         "  mma::mma_bf16(c0, a[0], b2[0], b2[1]);     // hi.lo\n"
         "  mma::mma_bf16(c1, a[0], b2[2], b2[3]);\n"
         "  mma::mma_bf16(c0, a[1], b1[0], b1[1]);     // mid.mid\n"
         "  mma::mma_bf16(c1, a[1], b1[2], b1[3]);\n"
         "  mma::mma_bf16(c0, a[2], b0[0], b0[1]);     // lo.hi\n"
         "  mma::mma_bf16(c1, a[2], b0[2], b0[3]);\n", "", 1)]),
    ("heads: no h_prev, g pieces", [
        ("      split3_store4(H3 + so4, H3 + HP + so4, H3 + 2 * HP + so4, hv);\n"
         "      split3_store4(G3 + so4, G3 + HP + so4, G3 + 2 * HP + so4, gv);",
         "      if (dp < 0) {\n"
         "      split3_store4(H3 + so4, H3 + HP + so4, H3 + 2 * HP + so4, hv);\n"
         "      split3_store4(G3 + so4, G3 + HP + so4, G3 + 2 * HP + so4, gv);\n"
         "      }", 1)]),
    ("heads: no exp on the diagonal", [
        ("j <= i ? v * expf(ci - cumv[j]) * dtv[j] : 0.f;",
         "j <= i ? v * dtv[j] : 0.f;", 1),
        ("j >= i ? v * expf(cumv[j] - ci) : 0.f;", "j >= i ? v : 0.f;", 1)]),
]
ABLATE_SHAPE = (8, 48, 512, 64, 128)    # mamba2-780m's training shape
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
    ssd_scan, rglru_scan, weight_transform, chip_smoke,
    flash_attention_bwd, rmsnorm)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import flash_attention_bwd as bmod
    from repro_torch.kernels import quant_matmul as qmod
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.kernels import rmsnorm as nmod
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
    return (cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke, bmod,
            nmod)


def norm_inputs(dev, g, shape, dtype, scale_dtype):
    """(x, scale, g) of one rmsnorm shape, as phases 3 and 27 make them."""
    import torch
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    sc = (torch.randn(shape[-1], generator=g, device=dev) * 0.1).to(
        scale_dtype)
    return x, sc, torch.randn(*shape, generator=g, device=dev).to(dtype)


def bwd_inputs(dev, g, B, S, H, K, dh, causal, window, dtype):
    """(q, k, v, o, lse, dO) of one backward shape, o and lse from the
    tree's own forward."""
    import torch
    from repro_torch.kernels import flash_attention as fmod
    q, do = (torch.randn(B, S, H, dh, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, K, dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    o, lse = fmod.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    return q, k, v, o, lse, do


def one_tree(tree: str) -> dict:
    """Build and time one tree's kernels (in this process)."""
    import torch
    cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke, bmod, nmod = \
        use_tree(tree)
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
    for name, B, S, H, K, dh, win in BWD:
        q, k, v, o, lse, do = bwd_inputs(dev, g, B, S, H, K, dh, True, win,
                                         torch.bfloat16)
        out[name] = chip_smoke.device_ms(lambda: bmod.flash_attention_bwd(
            q, k, v, o, lse, do, window=win))
        del q, k, v, o, lse, do
    gh = torch.Generator(device=dev).manual_seed(26)
    f32 = {}
    for B, S, H, K, dh, causal, win in BWD_F32:
        args = bwd_inputs(dev, gh, B, S, H, K, dh, causal, win,
                          torch.float32)
        h = hashlib.sha256()
        for t in (*args[3:5], *bmod.flash_attention_bwd(
                *args, causal=causal, window=win)):
            h.update(t.cpu().numpy().tobytes())
        f32[f"{B, S, H, K, dh, causal, win}"] = h.hexdigest()[:16]
    for name, shape, dt, sdt in NORM:
        x, sc, _ = norm_inputs(dev, g, shape, getattr(torch, dt),
                               getattr(torch, sdt))
        out[name] = chip_smoke.device_ms(lambda: nmod.rmsnorm(x, sc))
    for name, shape, dt, sdt in NORM_BWD:
        x, sc, gy = norm_inputs(dev, g, shape, getattr(torch, dt),
                                getattr(torch, sdt))
        out[name] = chip_smoke.device_ms(lambda: nmod.rmsnorm_bwd(x, sc, gy))
    gn = torch.Generator(device=dev).manual_seed(27)
    h = hashlib.sha256()
    for shape in NORM_F32:
        x, sc, gy = norm_inputs(dev, gn, shape, torch.float32, torch.float32)
        for t in nmod.rmsnorm_bwd(x, sc, gy):
            h.update(t.cpu().numpy().tobytes())
    res = {"build_s": build_s, "ms": out, "f32": f32,
           "norm_f32": h.hexdigest()[:16]}
    if hasattr(smod, "ssd_scan_bwd"):
        res["scan_bwd_f32"] = time_scan_bwd(chip_smoke, smod, rmod, dev, g,
                                            out)
    return res


def scan_bwd_inputs(dev, g, kind, *shape, dtype=None):
    """A scan backward's inputs: (x, dt, A, B, C, dy) for ssd_scan_bwd
    (x and dy in ``dtype``, default bf16), (a, y, g) for rglru_scan_bwd
    with y the forward's output."""
    import torch
    if kind == "ssd":
        x, dt, A, B, C = scan_inputs(dev, g, "ssd", *shape)
        dtype = dtype or torch.bfloat16
        return (x.to(dtype), dt, A, B, C,
                torch.randn(x.shape, generator=g, device=dev).to(dtype))
    from repro_torch.kernels import rglru_scan as rmod
    a, b = scan_inputs(dev, g, "rglru", *shape)
    return a, rmod.rglru_scan(a, b), torch.randn(
        a.shape, generator=g, device=dev)


def time_scan_bwd(chip_smoke, smod, rmod, dev, g, out) -> str:
    """Time both scan backwards at the training shapes into ``out`` (device
    and eager); returns the hash of their f32 results at
    :data:`SCAN_BWD_F32` (one seed)."""
    import torch
    for name, *shape in SSD_BWD:
        args = scan_bwd_inputs(dev, g, "ssd", *shape)
        out[name] = chip_smoke.device_ms(lambda: smod.ssd_scan_bwd(*args),
                                         iters=5, replays=3)
        out[name + " eager"] = chip_smoke.call_ms(
            lambda: smod.ssd_scan_bwd(*args), iters=5)
        del args
    for name, *shape in RGLRU_BWD:
        args = scan_bwd_inputs(dev, g, "rglru", *shape)
        out[name] = chip_smoke.device_ms(lambda: rmod.rglru_scan_bwd(*args))
        out[name + " eager"] = chip_smoke.call_ms(
            lambda: rmod.rglru_scan_bwd(*args))
        del args
    gs = torch.Generator(device=dev).manual_seed(28)
    h = hashlib.sha256()
    for kind, *shape in SCAN_BWD_F32:
        args = scan_bwd_inputs(dev, gs, kind, *shape, dtype=torch.float32)
        fn = smod.ssd_scan_bwd if kind == "ssd" else rmod.rglru_scan_bwd
        for t in fn(*args):
            if t is not None:                  # rglru's dh0, not asked for
                h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ablated_source(source: str, edits) -> str:
    """``source`` with each (text, replacement, times) of ``edits`` made;
    raises unless the text occurs exactly that many times."""
    for old, new, times in edits:
        if source.count(old) != times:
            raise ValueError(f"ablation text found {source.count(old)} "
                             f"times, not {times}: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def ablate() -> int:
    """Build this tree's port with each of :data:`ABLATIONS` (and without
    any) under ``build/ablate/``, all at once, then time each copy's
    ``ssd_scan_bwd`` in a process of its own."""
    base = os.path.join(ROOT, "build", "ablate")
    cu = os.path.join("src", "repro_torch", "kernels", "csrc",
                      "ssd_scan_bwd.cu")
    source = open(os.path.join(ROOT, cu)).read()
    trees = []
    for i, (name, edits) in enumerate([("none", [])] + ABLATIONS):
        tree = os.path.join(base, str(i))
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                        os.path.join(tree, "src", "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(tree, cu), "w") as f:
            f.write(ablated_source(source, edits))
        trees.append((name, tree))
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--ablated", tree,
                                "--build-only"]) for _, tree in trees]
    if any(p.wait() for p in builds):
        return 1
    for name, tree in trees:
        r = subprocess.run([sys.executable, me, "--ablated", tree],
                           capture_output=True, text=True)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"ssd_bwd bf16 {ABLATE_SHAPE} without {name}: "
              f"{res['ms']:.5f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in res["split"].items())
              + ")", flush=True)
    return 0


def ablated(tree: str, build_only: bool) -> None:
    """Build (and unless ``build_only`` time) ``ssd_scan_bwd`` of the copy
    at ``tree``, its library holding that source alone; prints one JSON
    line."""
    import torch
    cuda_lib, _, _, _, smod, _, _, chip_smoke, _, _ = use_tree(tree)
    cuda_lib._sources = lambda: [cuda_lib.CSRC / "ssd_scan_bwd.cu"]
    cuda_lib.SIGNATURES = {k: v for k, v in cuda_lib.SIGNATURES.items()
                           if k.startswith("repro_ssd_scan_bwd")}
    cuda_lib.library()
    if build_only:
        return
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    args = scan_bwd_inputs(dev, g, "ssd", *ABLATE_SHAPE)

    def call():
        smod.ssd_scan_bwd(*args)
    split = chip_smoke.kernel_ms(call, n=5)
    print(json.dumps({
        "ms": chip_smoke.device_ms(call, iters=5, replays=3),
        "split": {k.split("::")[-1].split("(")[0]: v
                  for k, v in split.items()}}))


def sweep() -> None:
    """The launch choices of this tree's plans, timed at the path shapes
    (the results of each choice are checked bit-equal to the wrapper's)."""
    import torch
    cuda_lib, fmod, qmod, dmod, smod, rmod, wmod, chip_smoke, bmod, nmod = \
        use_tree(ROOT)
    lib = cuda_lib.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    sweep_rmsnorm(cuda_lib, nmod, chip_smoke, lib, dev, g)
    norm_rounding(cuda_lib, nmod, chip_smoke, lib, dev)
    sweep_bwd(cuda_lib, bmod, chip_smoke, lib, dev, g)
    sweep_transform(wmod, chip_smoke, lib, dev, g)
    sweep_scans(cuda_lib, smod, rmod, chip_smoke, lib, dev, g)
    sweep_scan_bwd(cuda_lib, smod, rmod, chip_smoke, lib, dev, g)
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
                    None, B, H, K, S, S, dh, 1, *q.stride()[:3],
                    *k.stride()[:3],
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


def sweep_rmsnorm(cuda_lib, nmod, chip_smoke, lib, dev, g) -> None:
    """rmsnorm at each (threads a row, teams a block, rows a team) and
    rmsnorm_bwd at each (threads a row, rows a team: its block rule) at
    the NORM shapes: the plan's (starred) bit-equal to the wrapper, every
    other within phase 3's (27's) bf16 tolerance of the plain version; a
    launch the entry refuses (shared memory, chunks) is shown as such.
    Then the plan's backward split into its two launches, and the library
    beside it: F.rms_norm's forward and its autograd's kernels."""
    import torch
    import torch.nn.functional as F
    for name, shape, dt, sdt in NORM + NORM_BWD:
        bwd = name.startswith("rmsnorm_bwd")
        dt, sdt = getattr(torch, dt), getattr(torch, sdt)
        x, sc, gy = norm_inputs(dev, g, shape, dt, sdt)
        d = shape[-1]
        rows = x.numel() // d
        p = nmod.plan(d, dt, sdt)
        bnd = (3 if bwd else 2) * x.numel() * x.element_size() / \
            chip_smoke.HBM_BPS * 1e3
        if bwd:
            want = nmod.rmsnorm_bwd(x, sc, gy)
            ref = nmod.plain_bwd(x, sc, gy)
        else:
            want = (nmod.rmsnorm(x, sc),)
            ref = (nmod.plain(x, sc),)
        row = []
        for threads in (32, 64, 128, 256):
            if nmod.chunks_a_thread(d, dt, threads) > nmod.MAX_CHUNKS:
                continue
            full = nmod.BLOCK // threads
            for teams in sorted({full, max(1, full // 2)}, reverse=True):
                for team_rows in ((1, 2, 4, 8) if bwd else (1, 2, 4)):
                    per = teams * team_rows
                    out = [torch.empty_like(x)]
                    if bwd:
                        part = torch.empty((-(-rows // per), d),
                                           dtype=torch.float64, device=dev)
                        out.append(torch.empty(d, device=dev))

                        def call():
                            return lib.repro_rmsnorm_bwd(
                                x.data_ptr(), sc.data_ptr(), gy.data_ptr(),
                                out[0].data_ptr(), part.data_ptr(),
                                out[1].data_ptr(), rows, d, 1e-6, 1,
                                int(sdt == torch.bfloat16), threads, teams,
                                team_rows, p.vec, cuda_lib.stream_ptr(dev))
                    else:
                        def call():
                            return lib.repro_rmsnorm(
                                x.data_ptr(), sc.data_ptr(),
                                out[0].data_ptr(), rows, d, 1e-6, 1,
                                int(sdt == torch.bfloat16), threads, teams,
                                team_rows, p.vec, cuda_lib.stream_ptr(dev))
                    what = f"{threads}x{teams}x{team_rows}"
                    if call():
                        row.append(f"{what} refused")
                        continue
                    torch.cuda.synchronize()
                    got = [out[0]] + ([out[1].to(sdt)] if bwd else [])
                    nt = nmod.bwd_teams(p) if bwd else p.rows
                    mine = (threads, teams, team_rows) == (
                        p.threads, nt, p.bwd_rows // nt if bwd else 1)
                    if mine:
                        assert all(torch.equal(a, b) for a, b in
                                   zip(got, want)), (name, what)
                    errs = [chip_smoke.rel_err(a, b)
                            for a, b in zip(got, ref)]
                    assert max(errs) <= chip_smoke.BF16_ATOL, (name, what,
                                                               errs)
                    ms = chip_smoke.device_ms(
                        lambda: cuda_lib.check(call(), name))
                    row.append(f"{what}{'*' if mine else ''} {ms:.5f} ms "
                               f"{bnd / ms:.0%}")
        print(f"{name} [threads x teams x rows a team; bound {bnd:.5f} ms, "
              f"plan {tuple(p)}]: " + ", ".join(row), flush=True)
        if bwd:
            split = chip_smoke.kernel_ms(
                lambda: nmod.rmsnorm_bwd(x, sc, gy), per_launch=True)
            xl = x.detach().requires_grad_()
            wl = (1.0 + sc.float()).detach().requires_grad_()
            lib_out = F.rms_norm(xl, (d,), wl.to(dt), 1e-6)
            lib_split = chip_smoke.kernel_ms(lambda: torch.autograd.grad(
                lib_out, (xl, wl), gy, retain_graph=True))
            print(f"{name}: the plan's launches (torch.profiler) " + ", ".join(
                f"{k[:60]} {v:.5f}" for k, v in split.items()) +
                f"; autograd of F.rms_norm: its kernels "
                f"{sum(lib_split.values()):.5f} ms of device time", flush=True)
        else:
            w = (1.0 + sc.float()).to(dt)
            lib_ms = chip_smoke.device_ms(
                lambda: F.rms_norm(x, (d,), w, 1e-6))
            print(f"{name}: F.rms_norm {lib_ms:.5f} ms", flush=True)
        del x, sc, gy, want, ref
        torch.cuda.empty_cache()


def norm_rounding(cuda_lib, nmod, chip_smoke, lib, dev) -> None:
    """Phase 27's ``rmsnorm_bwd`` case at f32 x and a bf16 scale at its
    first shape (the training rows), replayed from phase 27's generator:
    for each launch shape of the backward, how far its f32 dscale is from
    an f64 sum (a fraction of max |dscale|) and in how many elements its
    bf16 dscale differs from autograd's, which phase 27 holds equal."""
    import torch
    g = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    for B, S, H, K, dh, _, _, dts in chip_smoke.BWD_CASES:
        for _ in dts:                      # phase 27's draws before rmsnorm
            for h in (H, H, K, K):
                randn(B, S, h, dh)
    shape = chip_smoke.NORM_BWD_CASES[0]
    for dt in (torch.bfloat16, torch.float32):
        for sdt in (torch.float32, torch.bfloat16):
            x = randn(*shape).to(dt) * 3
            sc = (randn(shape[-1]) * 0.1).to(sdt)
            gy = randn(*shape).to(dt)
            if (dt, sdt) == (torch.float32, torch.bfloat16):
                break
        else:
            continue
        break
    d = shape[-1]
    rows = x.numel() // d
    xa, sa = x.detach().requires_grad_(), sc.detach().requires_grad_()
    want = torch.autograd.grad(nmod.plain(xa, sa), (xa, sa), gy)[1]
    sf = sc.float().detach().requires_grad_()
    auto = torch.autograd.grad(nmod.plain(x, sf), (sf,), gy)[0]
    xd, gd = x.double().reshape(rows, d), gy.double().reshape(rows, d)
    exact = (gd * xd * torch.rsqrt(xd.square().mean(-1, keepdim=True)
                                   + 1e-6)).sum(0)
    top = exact.abs().max().item()

    def off(t):
        return (t.double() - exact).abs().max().item() / top
    row = [f"autograd's f32 sum off by {off(auto):.2e}, its bf16 rounding "
           f"unlike the f64 sum's in "
           f"{int((exact.float().to(sdt) != want).sum())}"]
    p = nmod.plan(d, dt, sdt)
    for threads in (32, 64, 128, 256):
        if nmod.chunks_a_thread(d, dt, threads) > nmod.MAX_CHUNKS:
            continue
        teams = nmod.BLOCK // threads
        for team_rows in (1, 2, 4, 8):
            part = torch.empty((-(-rows // (teams * team_rows)), d),
                               dtype=torch.float64, device=dev)
            dx, ds = torch.empty_like(x), torch.empty(d, device=dev)
            if lib.repro_rmsnorm_bwd(
                    x.data_ptr(), sc.data_ptr(), gy.data_ptr(), dx.data_ptr(),
                    part.data_ptr(), ds.data_ptr(), rows, d, 1e-6, 0, 1,
                    threads, teams, team_rows, p.vec,
                    cuda_lib.stream_ptr(dev)):
                continue
            torch.cuda.synchronize()
            mine = (threads, team_rows) == (p.threads,
                                            p.bwd_rows // nmod.bwd_teams(p))
            row.append(f"{threads}x{teams}x{team_rows}{'*' if mine else ''} "
                       f"off by {off(ds):.2e}, bf16 unlike autograd's in "
                       f"{int((ds.to(sdt) != want).sum())}")
    print(f"rmsnorm_bwd, phase 27's f32 x / bf16 scale {shape} [threads x "
          f"teams x rows a team; of max |dscale|; elements of {d}]: "
          + "; ".join(row), flush=True)


def sweep_bwd(cuda_lib, bmod, chip_smoke, lib, dev, g) -> None:
    """flash_attention_bwd at each (kv rows, q keys) pair of tiles its
    padded dim is built at, at the BWD shapes: the plan's (starred)
    bit-equal to the wrapper, every pair within phase 27's bf16 tolerance
    of each gradient's max |g| against the plain version; each pair's
    device ms and its three kernels' (torch.profiler), then SDPA's
    backward on the same inputs, eager and its kernels' device time."""
    import torch
    for name, B, S, H, K, dh, win in BWD:
        q, k, v, o, lse, do = bwd_inputs(dev, g, B, S, H, K, dh, True, win,
                                         torch.bfloat16)
        want = bmod.flash_attention_bwd(q, k, v, o, lse, do, window=win)
        ref = bmod.plain(q, k, v, o, lse, do, window=win)
        dp = bmod.padded_dim(dh)
        best = bmod.plan_bwd(B, S, H, K, dh)
        rows = sorted({bmod.TILES[dp][1], bmod.ALT_TILES[dp][0]})
        keys = sorted({bmod.TILES[dp][2], bmod.ALT_TILES[dp][1]})
        row = []
        for kv_rows, q_keys in itertools.product(rows, keys):
            got = [torch.empty_like(t) for t in (q, k, v)]
            D = torch.empty((B, H, S), dtype=torch.float32, device=dev)

            def call():
                cuda_lib.check(lib.repro_flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), *(t.data_ptr()
                                                     for t in got),
                    D.data_ptr(), B, H, K, S, dh, 1, 1, win,
                    1.0 / math.sqrt(dh), kv_rows, q_keys,
                    cuda_lib.stream_ptr(dev)), name)
            call()
            torch.cuda.synchronize()
            mine = (kv_rows, q_keys) == (best.kv_rows, best.q_key_tile)
            if mine:
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (name, kv_rows, q_keys)
            errs = [chip_smoke.rel_err(a, b) for a, b in zip(got, ref)]
            assert max(errs) <= chip_smoke.BF16_ATOL, (name, kv_rows,
                                                       q_keys, errs)
            split = chip_smoke.kernel_ms(call)
            parts = " / ".join(
                f"{sum(t for n, t in split.items() if part in n):.4f}"
                for part in ("dot_rows", "bwd_kv_tc", "bwd_q_tc"))
            row.append(f"kv rows {kv_rows} q keys {q_keys}"
                       f"{'*' if mine else ''} "
                       f"{chip_smoke.device_ms(call):.5f} ms (D / kv / q "
                       f"{parts})")
        print(f"{name}: " + ", ".join(row), flush=True)
        mask = bmod.visible(S, S, True, win, dev) if win else None
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=not win, enable_gqa=True)
        dot = do.transpose(1, 2)

        def sdpa():
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        print(f"{name}: SDPA's backward {chip_smoke.call_ms(sdpa):.5f} ms "
              f"eager, its kernels "
              f"{sum(chip_smoke.kernel_ms(sdpa).values()):.5f} ms of device "
              f"time", flush=True)
        del q, k, v, o, lse, do, want, ref, got, qt, kt, vt, out
        torch.cuda.empty_cache()


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


def sweep_scan_bwd(cuda_lib, smod, rmod, chip_smoke, lib, dev, g) -> None:
    """ssd_scan_bwd's bf16 instances (Q: the kept states' and the heads
    pass's steps, L: the walks' steps, P: dp rows a walk block) at the
    training shape and at dp 16, each against the plain version within
    phase 28's tolerances, the plan's and the others of its chunk length
    bit-equal to the wrapper (the rows a walk block change no bits), device
    ms by graph replay and each of the three kernels' by torch.profiler;
    both scan backwards at the training shapes beside the plain versions
    and the bounds (device ms by graph replay, eager ms by events)."""
    import torch
    for name, b, nh, S, dp, N in SSD_BWD + [
            ("ssd_bwd bf16 (8,48,512,16) N128", 8, 48, 512, 16, 128)]:
        x, dt, A, B, C, dy = scan_bwd_inputs(dev, g, "ssd", b, nh, S, dp, N)
        want = smod.ssd_scan_bwd(x, dt, A, B, C, dy)
        ref = smod.plain_bwd(x, dt, A, B, C, dy)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = (torch.empty_like(x), torch.empty((b, nh, S), **f32),
                torch.empty((nh,), **f32), torch.empty((b, S, N), **f32),
                torch.empty((b, S, N), **f32))
        best = smod.plan_bwd(dp, N, x.dtype)
        row = []
        for inst in smod.BWD_TC_PLANS:
            p = smod.BwdPlan(*inst, smod.BWD_STATE_COLS)
            scratch = smod.bwd_scratch(b, nh, S, dp, N, p, dev)

            def call():
                smod._launch_bwd_tc(x, dt, A, B, C, None, dy, *outs,
                                    *scratch, plan=p)
            call()
            torch.cuda.synchronize()
            mine = p == best
            if p.chunk == best.chunk:
                # the plan's, or other rows a walk block: the same bits
                assert all(torch.equal(u, w) for u, w in zip(outs, want))
            errs = [chip_smoke.rel_err(u, w) for u, w in zip(outs, ref)]
            assert errs[0] <= chip_smoke.BF16_ATOL and \
                max(errs[1:]) <= chip_smoke.F32_ATOL, (name, inst, errs)
            ms = chip_smoke.device_ms(call, iters=5, replays=3)
            split = chip_smoke.kernel_ms(call, n=5)
            row.append(f"Q={p.chunk} L={p.walk} P={p.cols}"
                       f"{'*' if mine else ''} {ms:.5f} ms ("
                       + ", ".join(f"{k.split('::')[-1].split('(')[0]} "
                                   f"{v:.4f}" for k, v in split.items())
                       + ")")
            del scratch
        print(f"{name}: " + "; ".join(row), flush=True)
        del x, dy, want, ref, outs
    for name, b, nh, S, dp, N in SSD_BWD:
        args = scan_bwd_inputs(dev, g, "ssd", b, nh, S, dp, N)
        bnd, bounds = chip_smoke.ssd_bwd_bounds(b, nh, S, dp, N)
        print_beside_plain(chip_smoke, name, lambda: smod.ssd_scan_bwd(*args),
                           lambda: smod.plain_bwd(*args), bnd, iters=5)
        print(f"{name} bounds: " + "; ".join(
            f"{k} {ms:.6f} ms ({by})" for k, (ms, by) in bounds.items()),
            flush=True)
        del args
    for name, Bz, S, W in RGLRU_BWD:
        args = scan_bwd_inputs(dev, g, "rglru", Bz, S, W)
        print_beside_plain(chip_smoke, name,
                           lambda: rmod.rglru_scan_bwd(*args),
                           lambda: rmod.plain_bwd(*args), chip_smoke.bound(
                               5 * 4 * Bz * S * W, 3 * Bz * S * W,
                               torch.float32))
        del args


def print_beside_plain(chip_smoke, name, kernel, plain, bnd,
                       iters: int = 20) -> None:
    """One line: the kernel's device ms (graph replay) and eager ms, the
    plain version's device ms and the bound."""
    ms = chip_smoke.device_ms(kernel, iters=iters, replays=3)
    eager = chip_smoke.call_ms(kernel, iters=iters)
    plain_ms = chip_smoke.device_ms(plain, iters=1, replays=2)
    print(f"{name}: kernel {ms:.5f} ms, eager {eager:.5f}, plain "
          f"{plain_ms:.5f}, bound {bnd[0]:.6f} ({bnd[1]}); bound / kernel "
          f"{bnd[0] / ms:.1%}", flush=True)


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
    ap.add_argument("--ablate", action="store_true",
                    help="ssd_scan_bwd with parts of its work taken out")
    ap.add_argument("--ablated", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.ablate:
        return ablate()
    if a.ablated:
        ablated(a.ablated, a.build_only)
        return 0
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
    hashes = []
    norm_hashes = {name: set() for name, _ in trees}
    scan_hashes = {name: set() for name, _ in trees}
    for name, tree in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout, r.stderr, file=sys.stderr)
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(name, json.dumps(res), flush=True)
        runs[name].append(res["ms"])
        hashes.append((name, res["f32"]))
        norm_hashes[name].add(res.get("norm_f32"))
        scan_hashes[name].add(res.get("scan_bwd_f32"))
    same = all(h == hashes[0][1] for _, h in hashes)
    print(f"flash_attention_bwd f32 results, {len(BWD_F32)} cases: "
          f"{'bit-equal in every turn' if same else 'DIFFER'}"
          + ("" if same else f" {hashes}"), flush=True)
    norm_same = all(len(h) == 1 for h in norm_hashes.values())
    print(f"rmsnorm_bwd f32 results, {len(NORM_F32)} cases: "
          f"{'bit-equal in the turns of each tree' if norm_same else 'DIFFER'}"
          f" {norm_hashes}", flush=True)
    scan_same = len(set().union(*scan_hashes.values())) == 1
    print(f"scan backwards' f32 results, {len(SCAN_BWD_F32)} cases: "
          f"{'bit-equal in every turn of both trees' if scan_same else 'DIFFER'}"
          f" {scan_hashes}", flush=True)
    same = same and norm_same and scan_same
    (na, ra), (nb, rb) = runs.items()
    print(f"{'shape':30s} {na + ' ms':>20s} {nb + ' ms':>20s} {'ratio':>7s}")
    for key in [k for k in ra[0] if k in rb[0]]:
        a_ms = [r[key] for r in ra]
        b_ms = [r[key] for r in rb]
        ratio = (sum(b_ms) / len(b_ms)) / (sum(a_ms) / len(a_ms))
        print(f"{key:30s} {a_ms[0]:9.5f},{a_ms[1]:9.5f} "
              f"{b_ms[0]:9.5f},{b_ms[1]:9.5f} {ratio:7.3f}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
