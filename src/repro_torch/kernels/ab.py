"""A/B device times of the redesigned kernels against another tree's.

    python3 src/repro_torch/kernels/ab.py --turns parent=DIR change=.

builds ``quant_matmul.cu``, ``flash_attention.cu`` and
``decode_attention.cu`` (with the headers beside them) of each named tree
into that tree's own ``build/``, then times the kernels at the main path's
shapes (and the decode kernels at a 2048-row cache) in turns, each tree in a
process of its own, in the order A, B, B, A, so that a drift of the card
over the run shows up as a difference between the two runs of one tree.
The decode kernels are also timed as eager calls (``chip_smoke.call_ms``,
host dispatch included: their extra key ends in ``eager``).  The
parent tree is made with ``git archive HEAD src/repro_torch | tar -x -C
DIR``.  Each tree is timed through its own wrappers, so trees whose C entry
points differ compare fine.  Prints one JSON line per turn and a table of
the means.

    python3 src/repro_torch/kernels/ab.py --sweep

times this tree's kernels at the launch choices their plans weigh, through
the C entry points: ``flash_attention`` with 1, 2 and 4 warps a block,
``quant_matmul`` with the slices in one block or in a block each, and the
two decode kernels at split lengths 16 to 256.  The plan's own choice is
checked bit-equal to the wrapper, the others against the plain version
within phase 3's bf16 tolerance.

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
KEEP = ("quant_matmul.cu", "flash_attention.cu", "decode_attention.cu")
ENTRIES = ("repro_quant_matmul", "repro_flash_attention",
           "repro_decode_attention", "repro_decode_attention_paged")

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
    chip_smoke)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import quant_matmul as qmod
    assert os.path.abspath(cuda_lib.__file__).startswith(
        os.path.abspath(tree)), cuda_lib.__file__
    cuda_lib._sources = lambda: sorted(
        p for p in cuda_lib.CSRC.glob("*.cu") if p.name in KEEP)
    cuda_lib.SIGNATURES = {k: v for k, v in cuda_lib.SIGNATURES.items()
                           if k in ENTRIES}
    sys.path.append(ROOT)
    import chip_smoke                 # after the tree's repro_torch
    return cuda_lib, fmod, qmod, dmod, chip_smoke


def one_tree(tree: str) -> dict:
    """Build and time one tree's kernels (in this process)."""
    import torch
    cuda_lib, fmod, qmod, dmod, chip_smoke = use_tree(tree)
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
    return {"build_s": build_s, "ms": out}


def sweep() -> None:
    """The launch choices of this tree's plans, timed at the path shapes
    (the results of each choice are checked bit-equal to the wrapper's)."""
    import torch
    cuda_lib, fmod, qmod, dmod, chip_smoke = use_tree(ROOT)
    lib = cuda_lib.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
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
                    fmod.KEY_TILE[dh], cuda_lib.stream_ptr(dev)),
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


def sweep_decode(cuda_lib, dmod, chip_smoke, lib, dev, g) -> None:
    """Split lengths of the decode kernels at each DECODE shape."""
    import torch
    for name, H, K, dh, S_max, pos, pt in DECODE:
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
                               * (dh + 2), device=dev)

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="time this tree (one turn)")
    ap.add_argument("--turns", nargs=2, metavar="NAME=DIR",
                    help="two trees, timed A, B, B, A")
    ap.add_argument("--sweep", action="store_true",
                    help="this tree's launch choices")
    a = ap.parse_args()
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
