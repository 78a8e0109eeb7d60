#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Drives the port's paths once each.  First, right after the kernels, the
MoE configs at full size, their int8 stores in ``/dev/shm``:
mixtral-8x7b at all 32 layers int8-resident (cicada, greedy generation,
the slotted and paged schedulers with a request past its window, the
logits held to a streamed f32 oracle, a step's costs) and one
arctic-480b layer (bf16 at A, int8-resident, f32 at A, both schedulers
with prefix reuse, its chunked prefill past its capacity drops), with
the dry run's meta table beside them.  Then, at the full width of
smollm-360m:
  * cold starts through the Cicada pipeline (cicada with the cast kernel,
    cicada with the dequant kernel, pisel), then greedy generation on the
    assembled params;
  * an int8-resident (``compute_quant``) cicada cold start;
  * warm generation of four concurrent requests through the
    continuous-batching ``DecodeScheduler`` on the int8-resident params,
    slotted, then paged with prefix reuse, one request resuming from the
    cold start's in-pipeline first token;
and at the full width of the two recurrent families, mamba2-780m (6 of
its 48 SSD layers, f32 store cast to bf16 at A) and recurrentgemma-2b (5
of its 26 layers: (rglru, rglru, attn) + 2 rglru, int8 store dequantized
to bf16 at A): a cicada
cold start, greedy generation, and four concurrent requests through the
slotted scheduler and through the paged one (recurrentgemma's attn
layers in 16-token pages, the recurrent states slot-resident; mamba2 pages
nothing); then each family int8-resident (``compute_quant``, mamba2 from
an int8 store of the same seed-0 weights): the cold start held to phase
6's rule against an f32 oracle, and the slotted and paged schedulers on
its params, with exact ``quant_matmul`` and ``weight_transform``
launches.  Last, the serverless platform serves both smollm-360m
and recurrentgemma-2b (at full width, 4 and 5 of their layers: the
platform's checks do not depend on depth) from their int8 stores with a
shared WeightCache:
a 16-invocation Azure-like trace replayed serially (its keep-alive
re-triggers cold starts, which read nothing from the store) and at
concurrency 4 (generation requests join live instances), then
smollm-360m int8-resident with 16-token pages against the same platform
slotted; every response's tokens equal ``reference_generate``'s, the
serial replay's launches are exact, and a sweep that evicts everything
returns the card's memory.  Then the paper's own evaluation trio at full
width (224x224 images, 1000 classes): resnet50, vgg16 and vit_b_16 cold
starts under all five strategies from f32 stores and with cicada from
int8 stores (one ``weight_transform`` launch per int8 leaf), each held
against the CPU, and served one-shot through the platform from their int8
stores (cold flags as the TTL implies, re-cold-starts read nothing, every
response equal to a standalone load's logits, memory returned).  Last,
the autoscaled platform: smollm-360m (4 layers) from its int8 store with
no cache,
fed a trickle and then a 10x burst open-loop, once without and once with
the SLO autoscaler, under the instrumented lock probe: prewarms only with
the autoscaler, loads = cold-served responses + prewarms with one store
read per unit and one ``weight_transform`` launch per int8 leaf each, every
response equal to a standalone load's, no lock-order cycle (observed, or
merged with the static graph) and no lock held across a store read, and
memory returned.  Then the MoE family and the audio and VLM stub families
at full width: mixtral-8x7b at 2 of its 32 layers from an int8 store
(cicada with bf16 at A and int8-resident, 32 greedy tokens, the slotted
scheduler on both residencies with tokens equal to
``reference_generate``'s and exact launch counts, the rows probe on a
decode step of each, memory returned), the same layers at f32 on the
card against the CPU with the routers' expert choices compared;
arctic-480b smoke (the dense residual) on the card against the CPU and
through the paged scheduler with prefix reuse; hubert-xlarge (all 48
encoder layers, dh 80, non-causal) from an int8 store, a one-shot frame
batch, and 4 layers against the CPU; internvl2-76b at 1 of its 80 layers
from an int8 store, image rows ahead of the tokens, greedy generation,
and the card against the CPU.  Last, the multi-node cluster on this one
card: smollm-360m (4 layers) from its int8 store served by simulated
nodes with
per-node WeightCaches, a 2000 MB/s origin shared by all and a 10000 MB/s
link a node, under the lock probe: a second node's cold start streams
every unit from its peer (no origin read), a four-node cold burst pays
one origin read a unit (four with peer exchange off), a trace replayed
through the locality-aware front end keeps the TTL's cold flags, every
response equals a standalone load's logits or ``reference_generate``'s
tokens, each load launches one ``weight_transform`` an int8 leaf, and
``flush()`` returns the card's memory and empties the placement table.
Last, shard-granular cold starts on a logical (1, 4) mesh of this card,
a simulated store channel a device, under the lock probe: full-width
smollm-360m from its f32 store (at f32 and with bf16 at A) and its int8
store (bf16 at A), each bit-equal in logits and params to a
single-device load, one shard stream a (unit, device) and one
``weight_transform`` launch a transformed piece; a cache-served second
load with no store open, an ``InstancePool(mesh_shape=4)`` scale-out,
``launch/serve.py --mesh 4``, and mixtral-8x7b's int8 store with its
experts two to a device.
Last, training on the card: the backward kernels of attention and
rmsnorm (``flash_attention_bwd``, ``rmsnorm_bwd``) against the autograd
of their plain versions, the card's loss and gradients against the CPU's
at 2 layers, then full-width smollm-360m trained for 15 steps through
``launch/train.py`` (int8 error-feedback compression, a checkpoint) with
exact launches a step, a falling loss, a bit-equal repeated step and a
resume equal to the straight run.  Last, training every other family:
the scans' backward kernels (``ssd_scan_bwd``, ``rglru_scan_bwd``)
against their plain formulas, the card's loss and gradients against the
CPU's for mamba2-780m and recurrentgemma-2b at small depth, both trained
at full width and depth through ``launch/train.py`` with exact launches a
step, a falling loss and a bit-equal repeated step, then a few steps of
mixtral-8x7b (2 layers), hubert-xlarge, internvl2-76b (1 layer) and
arctic-480b smoke, each step repeated bit-equal.  Last, chunked prefill
(``LM.prefill_chunked``, 2048-token chunks) at full width: smollm-360m f32
at B 2 and 8192 tokens against the unchunked prefill (logits and every
cache leaf) and 16 greedy decode steps from each cache; smollm-360m at
32768 tokens and internvl2-76b (1 layer, 256 image rows, 8192 rows) in
bf16, the greedy token equal and the logits moved no more than bf16 moves
them from f32; ms and peak memory chunked and unchunked, exact launches;
``flash_attention`` at the last chunk's shape against plain and SDPA.
Last, the dense configs at full width (2 layers each), one after another:
yi-9b, codeqwen1.5-7b and h2o-danube-3-4b, each from an int8 store
deployed one unit at a time from weights drawn on the card (the peak of
the process's resident memory bounded), cicada with bf16 at A and
int8-resident, greedy generation, the slotted and paged schedulers with
exact launches, h2o-danube's ring wrapped by a request 1024 tokens past
its 4096-token window and held in f32 to the windowed forward, and a few
layers on the card against the CPU.
It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (the
seven TPU kernels' counterparts, ``rmsnorm`` and the four backward
kernels), holds each against its
plain PyTorch version on the card, the attention kernels also at head dims
20, 80 and 120 (padded instances), and the kernels to their invariants:
``quant_matmul`` and ``rmsnorm`` rows bit-equal at any M, a
``prefill_continue``-shaped ``flash_attention`` call bit-equal to the full
prefill's last rows, decode rows bit-equal across the batch, the cache
length and pages against slots, the scans' rows bit-equal across the batch
and under trailing padding, ``weight_transform`` bit-equal on every path of
its plan (one row, 17 and 5003 at each column width it tells apart, a
misaligned ``w`` and ``scale``, the cast, a leaf past 2^31 elements, the
sharded path's slices); for
the recurrentgemma-2b and mixtral-8x7b loads that transform at A it prints
the load's summed ``weight_transform`` device time beside its work_A.
It checks that each path launched its kernels
(counts set to 0 just before a path and read just after; exact counts per
forward, prefill and decode step for the recurrent families), that the
scheduler's tokens equal ``reference_generate``'s and the paged run's the
slotted run's, and that no op of a recurrent decode step depends on the
batch (``kernels/ab.py``'s rows probe); it checks the card against the CPU
end to end (the recurrent families at 4 layers, yi-9b, codeqwen1.5-7b
and h2o-danube-3-4b's head dim 120 with a window at 2, f32), and prints one
JSON line of kernel numbers and, last, one JSON line ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero.

Without a CUDA device, or without the repository's ``src/repro_torch``
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BF16_ATOL = 2e-2
F32_ATOL = 1e-4

T_START = time.perf_counter()


class Failure(Exception):
    pass


def need(cond: bool, what: str):
    if not cond:
        raise Failure(what)


def phase(title: str):
    print(f"{title} (at {time.perf_counter() - T_START:.1f} s; host memory "
          f"{mem_available() / 1e9:.1f} GB available, "
          f"{meminfo('Shmem') / 1e9:.1f} GB in /dev/shm, this process "
          f"{rss_bytes() / 1e9:.1f} GB resident)", flush=True)


def meminfo(key: str) -> int:
    """A field of ``/proc/meminfo`` in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise Failure(f"no {key} in /proc/meminfo")


def mem_available() -> int:
    """The host's ``MemAvailable`` in bytes."""
    return meminfo("MemAvailable")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean time of one eager call: CUDA events around ``iters``
    back-to-back calls.  Where a call's device work is shorter than the
    host's dispatch of it, this times the dispatch."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph and timed with CUDA events over ``replays`` replays, so the
    host's per-call dispatch is not in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """Least time (ms) for the work, and what bounds it."""
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cost_bound(name: str, *args, peak, **kwargs) -> tuple:
    """:func:`bound` of registry kernel ``name``'s call on these
    arguments, its work as the package counts it
    (``ops.registry.spec(name).cost``, from their shapes); operations at
    the ``peak`` dtype's rate."""
    from repro_torch.kernels import ops
    flops, nbytes = ops.registry.spec(name).cost(*args, **kwargs)
    return bound(nbytes, flops, peak)


def decode_bound(pos, H: int, K: int, dh: int, NP: int = 0) -> tuple:
    """:func:`bound` of a bf16 decode step whose rows sit at ``pos``:
    ``decode_attention``'s cost of each row over the pos + 1 cache
    positions it reads (``cost`` counts a whole cache: the keys a row
    reads are this run's data), and for a paged step (``NP`` table
    entries a row) the int32 page table read once."""
    import torch
    from repro_torch.kernels import ops
    cost = ops.registry.spec("decode_attention").cost

    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    flops = nbytes = 0
    for t in pos:
        f, b = cost(m(1, H, dh), m(1, K, t + 1, dh), m(1, K, t + 1, dh),
                    m(1, dtype=torch.int32))
        flops, nbytes = flops + f, nbytes + b
    return bound(nbytes + 4 * len(pos) * NP, flops, torch.bfloat16)


def kernel_ms(fn, n: int = 10, per_launch: bool = False) -> dict:
    """Device ms of one call of ``fn`` by kernel name: the self device time
    of each kernel under torch.profiler over ``n`` calls (after 3 to warm
    up), divided by ``n`` (``per_launch``: by the launches the profiler
    saw, the mean of one launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t:
            div = ev.count if per_launch else n
            out[ev.key] = out.get(ev.key, 0.0) + t / div / 1e3
    return out


def union_ms(spans) -> float:
    """Milliseconds covered by (start_us, end_us) spans, overlaps once."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# (n, m) of the dequant cases: one row, 17 rows and a ragged 5003, at the
# main path's column widths, multiples of 16 (64, 960, 14336) and not (8,
# 120, 504, 1000: mixtral's router, h2o-danube's dh, hubert, the vision
# heads)
WT_WIDTHS = (8, 64, 120, 504, 960, 1000, 14336)
WT_ROWS = (1, 17, 5003)
# a leaf of more than 2^31 elements at arctic-480b's expert width
WT_HUGE = (450000, 4864)
# arctic-480b's expert leaf (128, 7168, 4864) as A applies it, (E * d, f)
# int8 rows: 4.46 G values, past 2^32
WT_EXPERT = (128 * 7168, 4864)
# the leaves dequantized whole at each use on the int8-resident recurrent
# paths
WT_AT_USE = (((1536, 6448), "mamba2 in_proj"),
             ((3072, 1536), "mamba2 out_proj"),
             ((256000, 2560), "recurrentgemma tied head"))


def check_weight_transform(dev, report: dict, g):
    """``weight_transform`` bit-equal to plain on the path's leaf shapes
    and on cases that reach every path of its plan, then timed at
    smollm's tok leaf (the JSON line's shape) and the cast of the same
    shape (``more``)."""
    import torch
    from repro_torch.kernels import weight_transform as wmod

    cases = []
    for n, m in [(14400, 64), (960, 960), (49152, 960), (17, 300)]:
        w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(m, generator=g, device=dev) * 0.05
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"dequant ({n},{m})->{str(dt)[6:]}", w, s, dt))
    for m in WT_WIDTHS:
        s = torch.rand(m, generator=g, device=dev) * 0.05
        for n in WT_ROWS:
            w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                              dtype=torch.int8)
            for dt in (torch.bfloat16, torch.float32):
                cases.append((f"dequant ({n},{m})->{str(dt)[6:]}", w, s, dt))
    buf = torch.randint(-127, 128, (5003 * 1000 + 8,), generator=g,
                        device=dev, dtype=torch.int8)
    sbuf = torch.rand(1001, generator=g, device=dev) * 0.05
    cases += [("dequant misaligned w (17,300)->bfloat16",
               buf[1:17 * 300 + 1].view(17, 300), sbuf[:300],
               torch.bfloat16),
              ("dequant w at 8 mod 16 (5003,960)->float32",
               buf[8:5003 * 960 + 8].view(5003, 960), sbuf[:960],
               torch.float32),
              ("dequant scale at 4 mod 16 (5003,1000)->bfloat16",
               buf[:5003 * 1000].view(5003, 1000), sbuf[1:], torch.bfloat16)]
    fbuf = torch.randn(49152 * 960 + 1, generator=g, device=dev)
    for n, m in ((49152, 960), (17, 300), (3, 7)):
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"cast ({n},{m}) f32->{str(dt)[6:]}",
                          fbuf[:n * m].view(n, m), None, dt))
    cases.append(("cast misaligned (17,300) f32->bfloat16",
                  fbuf[1:17 * 300 + 1].view(17, 300), None, torch.bfloat16))
    err, paths = 0.0, {}
    for name, w, s, dt in cases:
        # the path the wrapper takes (its output is a fresh, aligned tensor)
        p = wmod.plan(*w.shape, dt, w.data_ptr(),
                      None if s is None else s.data_ptr(), 0)
        got = wmod.weight_transform(w, s, out_dtype=dt)
        want = wmod.plain(w, s, out_dtype=dt)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = max(err, (got.float() - want.float()).abs().max().item())
        kind = ("dequant " if s is not None else "cast ") + p.path
        paths[kind] = paths.get(kind, 0) + 1
        if not same:
            print(f"  weight_transform {name} ({p}): MISMATCH")
        need(same, f"weight_transform {name} differs from its plain version")
    del buf, fbuf, cases
    print(f"  weight_transform: {sum(paths.values())} cases exact, by path "
          f"{paths}")
    # one leaf past 2^31 elements (64-bit offsets), and its plain version's
    # f32 temporaries, freed before the next check
    n, m = WT_HUGE
    w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(m, generator=g, device=dev) * 0.05
    got = wmod.weight_transform(w, s, out_dtype=torch.bfloat16)
    same = torch.equal(got, wmod.plain(w, s, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"  weight_transform dequant {WT_HUGE} ({n * m / 2 ** 31:.2f} x "
          f"2^31 elements)->bfloat16: {'exact' if same else 'MISMATCH'}")
    need(same, f"weight_transform {WT_HUGE} differs from its plain version")
    del w, s, got
    torch.cuda.empty_cache()
    n, m = WT_EXPERT
    w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(m, generator=g, device=dev) * 0.05
    got = wmod.weight_transform(w, s, out_dtype=torch.bfloat16)
    same = torch.equal(got, wmod.plain(w, s, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"  weight_transform dequant {WT_EXPERT} ({n * m / 2 ** 32:.2f} x "
          f"2^32 elements, arctic-480b's expert leaf)->bfloat16: "
          f"{'exact' if same else 'MISMATCH'}")
    need(same, f"weight_transform {WT_EXPERT} differs from its plain version")
    del got
    torch.cuda.empty_cache()
    extra_line("weight_transform", f"arctic-480b expert leaf int8 ({n},{m}) "
               f"-> bf16",
               lambda: wmod.weight_transform(w, s, out_dtype=torch.bfloat16),
               lambda: wmod.plain(w, s, out_dtype=torch.bfloat16),
               lambda: (w.float() * s).to(torch.bfloat16),
               cost_bound("weight_transform", w, s, out_dtype=torch.bfloat16,
                          peak=torch.float32),
               "(w.float() * s).to(dt)")
    del w, s
    torch.cuda.empty_cache()
    # main-path timing shape: the largest leaf, tok (49152, 960) int8 -> f32
    n, m = 49152, 960
    w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(m, generator=g, device=dev) * 0.05
    b_ms, b_by = cost_bound("weight_transform", w, s,
                            out_dtype=torch.float32, peak=torch.float32)
    report["weight_transform"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: wmod.weight_transform(w, s,
                                                   out_dtype=torch.float32)),
        call_ms=call_ms(lambda: wmod.weight_transform(w, s,
                                                      out_dtype=torch.float32)),
        plain_ms=device_ms(lambda: wmod.plain(w, s,
                                              out_dtype=torch.float32)),
        library_ms=device_ms(lambda: (w.float() * s).to(torch.float32)),
        library="(w.float() * s).to(dt)",
        bound_ms=b_ms, bound_by=b_by,
        shape="int8 (49152, 960) + f32 scale (960,) -> f32")
    wf = torch.randn(n, m, generator=g, device=dev)
    extra_line("weight_transform", "cast f32 (49152,960) -> bf16",
               lambda: wmod.weight_transform(wf, None),
               lambda: wmod.plain(wf, None),
               lambda: wf.to(torch.bfloat16),
               cost_bound("weight_transform", wf, peak=torch.float32),
               "w.to(torch.bfloat16)")
    del w, s, wf
    # the int8-resident recurrent paths' dequant at each use, to bf16:
    # mamba2's in_proj and out_proj, and recurrentgemma's tied head
    for (n, m), what in WT_AT_USE:
        w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(m, generator=g, device=dev) * 0.05
        got = wmod.weight_transform(w, s, out_dtype=torch.bfloat16)
        want = wmod.plain(w, s, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"  weight_transform dequant ({n},{m})->bfloat16 ({what}): "
              f"{'exact' if same else 'MISMATCH'}")
        need(same, f"weight_transform ({n},{m}) differs from its plain "
             f"version")
        del got, want
        extra_line("weight_transform", f"int8 ({n},{m}) -> bf16, {what}",
                   lambda: wmod.weight_transform(w, s,
                                                 out_dtype=torch.bfloat16),
                   lambda: wmod.plain(w, s, out_dtype=torch.bfloat16),
                   lambda: (w.float() * s).to(torch.bfloat16),
                   cost_bound("weight_transform", w, s,
                              out_dtype=torch.bfloat16, peak=torch.float32),
                   "(w.float() * s).to(dt)")
        del w, s
    torch.cuda.empty_cache()


# the pieces phase 26's placement lanes transform, as the lanes shape them
# ((-1, cols) of the piece): (label, (n, m), int8 store, out dtype)
WT_SLICES = (
    ("smollm mlp/wg column slice at (1,4), cast", (960, 640), False, "bf16"),
    ("smollm mlp/wd row slice at (1,4), cast", (640, 960), False, "bf16"),
    ("smollm tok row slice at (1,4), cast", (12288, 960), False, "bf16"),
    ("smollm tok row slice at (1,4), int8", (12288, 960), True, "bf16"),
    ("smollm mlp/wg int8 read whole (640-byte runs)", (960, 2560), True,
     "bf16"),
    ("mixtral expert wg 2-of-8 slice, int8", (2 * 4096, 14336), True,
     "bf16"),
    ("mixtral expert wd 2-of-8 slice, int8", (2 * 14336, 4096), True,
     "bf16"),
)


def check_slice_transforms(dev, g):
    """``weight_transform`` on the slice shapes of the sharded cold start,
    bit-equal to plain, and on one cast slice whose pointer is 4 bytes off
    16 (the scalar path), timed beside the same slice aligned."""
    import torch
    from repro_torch.kernels import weight_transform as wmod
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    timed = {"smollm mlp/wg column slice at (1,4), cast",
             "mixtral expert wg 2-of-8 slice, int8"}
    for label, (n, m), q, dt in WT_SLICES:
        dt = dts[dt]
        if q:
            w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand(m, generator=g, device=dev) * 0.05
        else:
            w = torch.randn(n, m, generator=g, device=dev)
            s = None
        got = wmod.weight_transform(w, s, out_dtype=dt)
        same = torch.equal(got, wmod.plain(w, s, out_dtype=dt))
        torch.cuda.synchronize()
        p = wmod.plan(n, m, dt, w.data_ptr(),
                      None if s is None else s.data_ptr(), got.data_ptr())
        print(f"  weight_transform {label} ({n},{m}) -> {str(dt)[6:]} "
              f"({p.path}): {'exact' if same else 'MISMATCH'}")
        need(same, f"weight_transform {label} differs from plain")
        if label in timed:
            extra_line("weight_transform", f"{label} ({n},{m}) -> "
                       f"{str(dt)[6:]}",
                       lambda: wmod.weight_transform(w, s, out_dtype=dt),
                       lambda: wmod.plain(w, s, out_dtype=dt),
                       lambda: (w.float() * s).to(dt) if q else w.to(dt),
                       cost_bound("weight_transform", w, s, out_dtype=dt,
                                  peak=torch.float32),
                       "(w.float() * s).to(dt)" if q else "w.to(dt)")
        del w, s, got
    # the wg column slice at a pointer 4 bytes off 16: the scalar path
    n, m = 960, 640
    buf = torch.randn(n * m + 1, generator=g, device=dev)
    w = buf[1:].view(n, m)
    p = wmod.plan(n, m, torch.bfloat16, w.data_ptr(), None, 0)
    need(p.path == "scalar", f"the unaligned slice takes {p.path}")
    same = torch.equal(wmod.weight_transform(w, None),
                       wmod.plain(w, None))
    torch.cuda.synchronize()
    print(f"  weight_transform unaligned wg slice ({n},{m}) f32 at 4 mod "
          f"16 -> bf16 ({p.path}): {'exact' if same else 'MISMATCH'}")
    need(same, "weight_transform on the unaligned slice differs from plain")
    extra_line("weight_transform", f"smollm mlp/wg column slice ({n},{m}) "
               f"f32 at 4 mod 16 -> bf16 (scalar path)",
               lambda: wmod.weight_transform(w, None),
               lambda: wmod.plain(w, None), lambda: w.to(torch.bfloat16),
               cost_bound("weight_transform", w, peak=torch.float32),
               "w.to(dt)")
    del buf, w
    torch.cuda.empty_cache()


def transform_share(store, name: str, out_dtype, work_a: float,
                    launched: int):
    """An estimate of the device time of a load's ``weight_transform``
    launches, not a time taken inside the load: each extent shape the A
    phase hands the kernel (as ``_apply_leaves`` shapes it: an int8 leaf as
    (-1, last), a cast as (first, -1) or (1, n)) timed alone with
    ``device_ms`` on random values, times its count; printed beside the
    load's work_A (host clock, summed over A's threads)."""
    import torch
    from repro_torch.kernels import weight_transform as wmod
    shapes = {}
    for u in store.manifest(name)["units"].values():
        for rec in u["extents"]:
            shape = rec["shape"]
            if rec.get("quant") == "int8":
                key = ("int8", math.prod(shape[:-1]), shape[-1])
            elif len(shape) >= 2:
                key = ("f32", shape[0], math.prod(shape[1:]))
            else:
                key = ("f32", 1, math.prod(shape))
            shapes[key] = shapes.get(key, 0) + 1
    need(sum(shapes.values()) == launched,
         f"{name}: {sum(shapes.values())} transformed extents, "
         f"{launched} weight_transform launches")
    g = torch.Generator(device="cuda").manual_seed(7)
    total = 0.0
    for (kind, n, m), count in sorted(shapes.items()):
        if kind == "int8":
            w = torch.randint(-127, 128, (n, m), generator=g, device="cuda",
                              dtype=torch.int8)
            s = torch.rand(m, generator=g, device="cuda")
        else:
            w, s = torch.randn(n, m, generator=g, device="cuda"), None
        total += count * device_ms(
            lambda: wmod.weight_transform(w, s, out_dtype=out_dtype))
        del w, s
    torch.cuda.empty_cache()
    print(f"  A share of {name}'s load (estimate: each extent shape timed "
          f"alone by graph replay, times its count): weight_transform "
          f"{launched} launches over {len(shapes)} extent shapes, "
          f"{total:.4f} ms of device time in all, beside work_A "
          f"{work_a * 1e3:.1f} ms (host clock)")
    return total


def check_kernels(dev, report: dict):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    check_weight_transform(dev, report, g)
    check_slice_transforms(dev, g)

    # --- flash_attention -----------------------------------------------------
    fl_err = 0.0
    flash_cases = [
        (1, 15, 5, 37, 37, 64, True, 0), (1, 15, 5, 128, 128, 64, True, 0),
        (1, 15, 5, 1000, 1000, 64, True, 0),
        (1, 15, 5, 100, 164, 64, True, 0), (1, 15, 5, 128, 128, 64, True, 16),
        (1, 15, 5, 128, 128, 64, False, 0), (1, 15, 5, 77, 77, 64, False, 16),
        (2, 8, 2, 70, 70, 128, True, 0), (1, 10, 1, 128, 128, 256, True, 0),
        (1, 10, 1, 100, 164, 256, True, 0), (2, 4, 2, 77, 77, 256, False, 16),
        # the MoE and stub paths: mixtral's window, hubert non-causal at
        # dh 80 (the dh-128 instance), internvl2's 64 query heads over 8
        (1, 32, 8, 128, 128, 128, True, 4096),
        (1, 16, 16, 256, 256, 80, False, 0), (1, 64, 8, 64, 64, 128, True, 0),
        # the dense configs: yi-9b's rep 8 and codeqwen1.5-7b's rep 1 at dh
        # 128, h2o-danube-3-4b's dh 120 with its window past 4096 rows
        (1, 32, 4, 128, 128, 128, True, 0),
        (1, 32, 32, 128, 128, 128, True, 0),
        (1, 32, 8, 5120, 5120, 120, True, 4096),
        # arctic-480b's 56 query heads over 8 (rep 7) at dh 128: a prompt,
        # and its chunked prefill's last 2048 queries over T 8192
        (1, 56, 8, 128, 128, 128, True, 0),
        (1, 56, 8, CHUNK, CHUNK_PROMPT, 128, True, 0)]
    for (B, H, K, S, T, dh, causal, win) in flash_cases:
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            q = randn(B, S, H, dh, dtype=dt)
            k = randn(B, T, K, dh, dtype=dt)
            v = randn(B, T, K, dh, dtype=dt)
            got = fmod.flash_attention(q, k, v, causal=causal, window=win)
            want = fmod.plain(q, k, v, causal=causal, window=win)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            fl_err = max(fl_err, e)
            print(f"  flash_attention B={B} H={H} K={K} S={S} T={T} dh={dh} "
                  f"causal={causal} window={win} {str(dt)[6:]}: "
                  f"max abs err {e:.3e} (tol {tol})")
            need(math.isfinite(e) and e <= tol,
                 f"flash_attention S={S} T={T} {dt} err {e}")
    # main-path timing shape: one cold-start attention E, 128-token prompt
    S, H, K, dh = 128, 15, 5, 64
    q = randn(1, S, H, dh, dtype=torch.bfloat16)
    k = randn(1, S, K, dh, dtype=torch.bfloat16)
    v = randn(1, S, K, dh, dtype=torch.bfloat16)
    b_ms, b_by = cost_bound("flash_attention", q, k, v, peak=torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    report["flash_attention"] = dict(
        max_abs_err=fl_err,
        ms=device_ms(lambda: fmod.flash_attention(q, k, v, causal=True)),
        call_ms=call_ms(lambda: fmod.flash_attention(q, k, v, causal=True)),
        plain_ms=device_ms(lambda: fmod.plain(q, k, v, causal=True)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        library="SDPA, is_causal, enable_gqa",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q (1,128,15,64), k/v (1,128,5,64), causal")
    S = 1000
    q = randn(1, S, H, dh, dtype=torch.bfloat16)
    k = randn(1, S, K, dh, dtype=torch.bfloat16)
    v = randn(1, S, K, dh, dtype=torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    extra_line("flash_attention", "bf16 q (1,1000,15,64), k/v (1,1000,5,64), "
               "causal",
               lambda: fmod.flash_attention(q, k, v, causal=True),
               lambda: fmod.plain(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               cost_bound("flash_attention", q, k, v, peak=torch.bfloat16))
    check_flash_continue(randn)
    # recurrentgemma's attention E: 10 query heads of dh 256 over 1 kv head
    S, H, K, dh = 128, 10, 1, 256
    q = randn(1, S, H, dh, dtype=torch.bfloat16)
    k = randn(1, S, K, dh, dtype=torch.bfloat16)
    v = randn(1, S, K, dh, dtype=torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    extra_line("flash_attention", "bf16 q (1,128,10,256), k/v (1,128,1,256), "
               "causal",
               lambda: fmod.flash_attention(q, k, v, causal=True),
               lambda: fmod.plain(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               cost_bound("flash_attention", q, k, v, peak=torch.bfloat16))

    # arctic-480b's heads (rep 7, dh 128): a 128-token prompt, and the last
    # chunk of its chunked prefill (2048 queries over T 8192)
    for S, T in ((128, 128), (CHUNK, CHUNK_PROMPT)):
        H, K, dh = 56, 8, 128
        q = randn(1, S, H, dh, dtype=torch.bfloat16)
        k = randn(1, T, K, dh, dtype=torch.bfloat16)
        v = randn(1, T, K, dh, dtype=torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if S == T:
            lib = "SDPA, is_causal, enable_gqa"

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        else:           # the bottom-right mask needs the kv heads repeated
            lib = "SDPA, causal_lower_right, kv heads repeated"
            mask = causal_lower_right(S, T)
            kt, vt = (x.repeat_interleave(H // K, dim=1) for x in (kt, vt))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        extra_line("flash_attention", f"bf16 q (1,{S},{H},{dh}), k/v "
                   f"(1,{T},{K},{dh}), causal (arctic-480b's heads)",
                   lambda: fmod.flash_attention(q, k, v, causal=True),
                   lambda: fmod.plain(q, k, v, causal=True), library,
                   cost_bound("flash_attention", q, k, v, peak=torch.bfloat16),
                   lib)
    del q, k, v, qt, kt, vt

    # --- decode_attention ---------------------------------------------------
    de_err = 0.0
    for (S_max, pos, win, H, K, dh) in [
            (512, (0, 37, 300, 511), 0, 15, 5, 64),
            (128, (5, 127, 300, 1000), 128, 15, 5, 64),
            (256, (0, 37, 159, 255), 0, 10, 1, 256),
            (64, (5, 63, 100, 300), 64, 8, 2, 256),
            # mixtral's ring (window 4096 over a 256-slot cache), internvl2
            (256, (0, 37, 159, 255), 4096, 32, 8, 128),
            (256, (0, 37, 159, 255), 0, 64, 8, 128),
            # arctic-480b: 56 query heads over 8 (rep 7)
            (256, (0, 37, 159, 255), 0, 56, 8, 128)]:
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            B = 4
            q = randn(B, H, dh, dtype=dt)
            kc = randn(B, K, S_max, dh, dtype=dt)
            vc = randn(B, K, S_max, dh, dtype=dt)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = dmod.decode_attention(q, kc, vc, p, window=win)
            want = dmod.plain(q, kc, vc, p, window=win)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            de_err = max(de_err, e)
            print(f"  decode_attention B={B} H={H} K={K} dh={dh} "
                  f"S_max={S_max} pos={pos} "
                  f"window={win} {str(dt)[6:]}: max abs err {e:.3e} "
                  f"(tol {tol})")
            need(math.isfinite(e) and e <= tol,
                 f"decode_attention window={win} {dt} err {e}")
    # main-path timing shape: one decode step of the generation phase
    # (B=1, cache_len 256, last step of a 128-token prompt + 32 tokens)
    H, K, dh, S_max, t = 15, 5, 64, 256, 159
    q = randn(1, H, dh, dtype=torch.bfloat16)
    kc = randn(1, K, S_max, dh, dtype=torch.bfloat16)
    vc = randn(1, K, S_max, dh, dtype=torch.bfloat16)
    p = torch.tensor([t], dtype=torch.int32, device=dev)
    rows = t + 1
    b_ms, b_by = decode_bound((t,), H, K, dh)
    q4 = q[:, :, None]
    report["decode_attention"] = dict(
        max_abs_err=de_err,
        ms=device_ms(lambda: dmod.decode_attention(q, kc, vc, p)),
        call_ms=call_ms(lambda: dmod.decode_attention(q, kc, vc, p)),
        plain_ms=device_ms(lambda: dmod.plain(q, kc, vc, p)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q4, kc[:, :, :rows], vc[:, :, :rows], enable_gqa=True)),
        library="SDPA over the valid rows, enable_gqa",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q (1,15,64), cache (1,5,256,64), pos 159")
    # recurrentgemma's decode step: 10 query heads of dh 256 over 1 kv head
    H, K, dh = 10, 1, 256
    q = randn(1, H, dh, dtype=torch.bfloat16)
    kc = randn(1, K, S_max, dh, dtype=torch.bfloat16)
    vc = randn(1, K, S_max, dh, dtype=torch.bfloat16)
    q4 = q[:, :, None]
    extra_line("decode_attention", "bf16 q (1,10,256), cache (1,1,256,256), "
               "pos 159",
               lambda: dmod.decode_attention(q, kc, vc, p),
               lambda: dmod.plain(q, kc, vc, p),
               lambda: F.scaled_dot_product_attention(
                   q4, kc[:, :, :rows], vc[:, :, :rows], enable_gqa=True),
               decode_bound((t,), H, K, dh))
    check_quant_matmul(dev, report, randn, g)
    check_paged(dev, report, randn, g)
    check_decode_splits(dev, randn)
    check_head_dims(dev, randn)
    check_scans(dev, report, randn, g)
    check_rmsnorm(dev, report, randn)
    for name, r in report.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms on the "
              f"device ({r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")


def check_flash_continue(randn):
    """A prefill_continue-shaped call (the last 64 queries at T = 128, k/v
    as transposed views of a kv-major cache) equals the last 64 rows of
    the full S = T = 128 call bit for bit: K tiles sit at absolute key
    positions, so a row's result does not depend on S or its q tile."""
    import torch
    from repro_torch.kernels import flash_attention as fmod
    for H, K, dh in ((15, 5, 64), (10, 1, 256)):
        q = randn(1, 128, H, dh, dtype=torch.bfloat16)
        kc = randn(1, K, 256, dh, dtype=torch.bfloat16)       # kv-major
        vc = randn(1, K, 256, dh, dtype=torch.bfloat16)
        k, v = kc[:, :, :128].transpose(1, 2), vc[:, :, :128].transpose(1, 2)
        full = fmod.flash_attention(q, k, v, causal=True)
        cont = fmod.flash_attention(q[:, 64:], k, v, causal=True)
        torch.cuda.synchronize()
        same = torch.equal(cont, full[:, 64:])
        print(f"  flash_attention continue S=64 at T=128 (H={H} K={K} "
              f"dh={dh}, strided kv-major views) vs the last 64 rows of "
              f"S=T=128: {'bit-equal' if same else 'DIFFERS'}")
        need(same, f"flash_attention rows depend on S at dh {dh}")


# kernel name -> the shapes timed beside its JSON line's own (``more``)
EXTRA = {}


def extra_line(name: str, shape: str, kernel, plain, library_fn, bnd,
               library: str = "library"):
    """Time a kernel at a second main-path shape, print it and keep it for
    the kernel's ``more`` list in the JSON line."""
    r = {"shape": shape, "ms": device_ms(kernel), "call_ms": call_ms(kernel),
         "plain_ms": device_ms(plain),
         "library_ms": device_ms(library_fn) if library_fn else None,
         "library": library, "bound_ms": bnd[0], "bound_by": bnd[1]}
    EXTRA.setdefault(name, []).append(r)
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"  {name} [{shape}]: kernel {r['ms']:.4f} ms on the device "
          f"({r['call_ms']:.4f} ms per eager call), plain "
          f"{r['plain_ms']:.4f} ms, {library} {lib}, "
          f"bound {bnd[0]:.6f} ms ({bnd[1]})")


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


# recurrentgemma-2b's int8-resident products: wx, wgate, wy, wq and wo
# (2560, 2560), wk and wv (2560, 256), the GeGLU MLP's wg and wu (2560,
# 7680) and wd (7680, 2560)
RG_PRODUCTS = ((2560, 2560), (2560, 256), (2560, 7680), (7680, 2560))
# codeqwen1.5-7b's untied head in a 4-slot decode step: (m, k, n)
CODEQWEN_HEAD = (4, 4096, 92416)
# phase 31's distinct int8-resident products (k, n): yi-9b's q/o, k/v,
# gate/up, down and untied head; codeqwen1.5-7b's gate/up, down and head
# (its q/o and k/v are yi-9b's q/o); h2o-danube-3-4b's q/o, k/v, gate/up,
# down and head
DENSE_PRODUCTS = ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
                  (4096, 64000), (4096, 13440), (13440, 4096), (4096, 92416),
                  (3840, 3840), (3840, 960), (3840, 10240), (10240, 3840),
                  (3840, 32000))


# phase 32's distinct int8-resident products (k, n) that phase 3 lacked:
# arctic-480b's q/o (7168, 7168), k/v (7168, 1024), experts' and dense
# residual's gate/up (7168, 4864) and down (4864, 7168), head (7168,
# 32000); mixtral-8x7b's k/v (4096, 1024), experts (4096, 14336) and
# (14336, 4096) (at m 4 only before) and head (4096, 32000)
MOE_PRODUCTS = ((7168, 7168), (7168, 1024), (7168, 4864), (4864, 7168),
                (7168, 32000), (4096, 1024), (4096, 14336), (14336, 4096),
                (4096, 32000))


def check_quant_matmul(dev, report: dict, randn, g):
    import torch
    from repro_torch.kernels import quant_matmul as qmod

    def qweight(k, n):
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        return w, torch.rand(n, generator=g, device=dev) * 0.02 + 1e-3

    err = 0.0                               # max abs error
    cases = [(4, 960, 49152), (128, 960, 2560), (1, 960, 960),
             (4, 2560, 960), (100, 70, 33), (17, 300, 5), (5, 64, 8192)] + [
        (4, k, n) for k, n in RG_PRODUCTS] + [
        (m, k, n) for m in (4, 128) for k, n in DENSE_PRODUCTS + MOE_PRODUCTS]
    for (m, k, n) in cases:
        w, s = qweight(k, n)
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            x = randn(m, k, dtype=dt)
            got = qmod.quant_matmul(x, w, s)
            want = qmod.plain(x, w, s)
            torch.cuda.synchronize()
            e = rel_err(got, want)
            err = max(err, (got.float() - want.float()).abs().max().item())
            print(f"  quant_matmul ({m},{k})x({k},{n}) {str(dt)[6:]}: max "
                  f"err {e:.3e} of max |out| (tol {tol})")
            need(got.dtype == dt and math.isfinite(e) and e <= tol,
                 f"quant_matmul ({m},{k},{n}) {dt} err {e}")
    # a misaligned weight (byte loads) and an f32 result from bf16 x
    buf = torch.randint(-127, 128, (300 * 64 + 1,), generator=g, device=dev,
                        dtype=torch.int8)
    w, s = buf[1:].view(300, 64), torch.rand(64, device=dev)
    x = randn(17, 300, dtype=torch.bfloat16)
    got = qmod.quant_matmul(x, w, s, out_dtype=torch.float32)
    want = qmod.plain(x, w, s, out_dtype=torch.float32)
    e = rel_err(got, want)
    print(f"  quant_matmul misaligned (17,300)x(300,64) bf16->f32: max err "
          f"{e:.3e} of max |out| (tol {F32_ATOL})")
    need(got.dtype == torch.float32 and e <= F32_ATOL,
         f"quant_matmul misaligned err {e}")
    err = max(err, (got - want).abs().max().item())
    # row independence: each row of an M-row product equals the M=1
    # product of that row, bit for bit (the scheduler steps at B = n_slots)
    for (k, n) in ((960, 49152), (960, 320), (2560, 960), *RG_PRODUCTS,
                   *DENSE_PRODUCTS, *MOE_PRODUCTS):
        w, s = qweight(k, n)
        x = randn(64, k, dtype=torch.bfloat16)
        rows = torch.cat([qmod.quant_matmul(x[i:i + 1], w, s)
                          for i in range(64)])
        for m in (1, 3, 4, 16, 64):
            full = qmod.quant_matmul(x[:m], w, s)
            torch.cuda.synchronize()
            same = torch.equal(full, rows[:m])
            print(f"  quant_matmul row independence ({k},{n}) M={m}: "
                  f"{'bit-equal' if same else 'DIFFERS'} to M=1")
            need(same, f"quant_matmul rows depend on M at ({k},{n}) M={m}")
    # main-path timing shape: the head in a 4-slot decode step
    m, k, n = 4, 960, 49152
    w, s = qweight(k, n)
    x = randn(m, k, dtype=torch.bfloat16)
    wd = (w.float() * s).to(torch.bfloat16)      # outside the timed region
    b_ms, b_by = cost_bound("quant_matmul", x, w, s, peak=torch.bfloat16)
    report["quant_matmul"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: qmod.quant_matmul(x, w, s)),
        call_ms=call_ms(lambda: qmod.quant_matmul(x, w, s)),
        plain_ms=device_ms(lambda: qmod.plain(x, w, s)),
        library_ms=device_ms(lambda: torch.matmul(x, wd)),
        library="torch.matmul on a bf16 copy of the weight dequantized "
                "outside the timed region",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 x (4,960) . int8 head (960,49152) + f32 scale")
    # every distinct smollm-360m projection (q/o, k/v, gate/up, down) at a
    # 4-slot decode step and at a 128-token prefill, mixtral-8x7b's expert
    # products (gate/up, down) and codeqwen1.5-7b's head at a 4-slot step
    for (m, k, n) in [(mm, kk, nn) for mm in (4, 128)
                      for (kk, nn) in ((960, 960), (960, 320), (960, 2560),
                                       (2560, 960))] + [
            (4, 4096, 14336), (4, 14336, 4096)] + [
            (4, k, n) for k, n in RG_PRODUCTS] + [CODEQWEN_HEAD] + [
            (4, k, n) for k, n in MOE_PRODUCTS[:5]]:
        w, s = qweight(k, n)
        x = randn(m, k, dtype=torch.bfloat16)
        wd = (w.float() * s).to(torch.bfloat16)
        extra_line("quant_matmul", f"bf16 x ({m},{k}) . int8 ({k},{n})",
                   lambda: qmod.quant_matmul(x, w, s),
                   lambda: qmod.plain(x, w, s),
                   lambda: torch.matmul(x, wd),
                   cost_bound("quant_matmul", x, w, s, peak=torch.bfloat16),
                   library="torch.matmul (bf16 copy)")


def check_paged(dev, report: dict, randn, g):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dmod

    B, H, K, dh, pt, NP = 4, 15, 5, 64, 16, 16
    P = B * NP + 1                                 # + the scratch page
    err = 0.0

    def make(pos, dt, seed):
        tables = page_tables(pos, pt, NP, seed, dev)
        return (randn(B, H, dh, dtype=dt), randn(P, K, pt, dh, dtype=dt),
                randn(P, K, pt, dh, dtype=dt), tables,
                torch.tensor(pos, dtype=torch.int32, device=dev))

    for pos, dims in (((37, 80, 123, 159), (15, 5, 64)),
                      ((0, 15, 16, 255), (15, 5, 64)),
                      ((37, 80, 123, 159), (10, 1, 256)),
                      ((37, 80, 123, 159), (32, 4, 128)),      # yi-9b
                      ((0, 15, 16, 255), (32, 32, 128)),       # codeqwen
                      ((37, 80, 123, 159), (56, 8, 128))):     # arctic
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            H, K, dh = dims
            q, kp, vp, tb, p = make(pos, dt, sum(pos))
            got = dmod.decode_attention_paged(q, kp, vp, tb, p)
            want = dmod.plain_paged(q, kp, vp, tb, p)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            err = max(err, e)
            print(f"  decode_attention_paged pos={pos} pt={pt} H={H} K={K} "
                  f"dh={dh} {str(dt)[6:]}: max abs err {e:.3e} (tol {tol})")
            need(math.isfinite(e) and e <= tol,
                 f"decode_attention_paged pos={pos} {dt} err {e}")
    # main-path timing shape: a 4-slot paged step of 128-token prompts
    H, K, dh = 15, 5, 64
    pos = (37, 80, 123, 159)
    q, kp, vp, tb, p = make(pos, torch.bfloat16, 1)
    b_ms, b_by = decode_bound(pos, H, K, dh, NP=NP)
    idx = tb.long()
    kg = kp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)  # gathered
    vg = vp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)  # outside
    valid = (torch.arange(NP * pt, device=dev)[None, :]
             <= p.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    report["decode_attention_paged"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: dmod.decode_attention_paged(q, kp, vp, tb, p)),
        call_ms=call_ms(lambda: dmod.decode_attention_paged(q, kp, vp, tb,
                                                            p)),
        plain_ms=device_ms(lambda: dmod.plain_paged(q, kp, vp, tb, p)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=valid, enable_gqa=True)),
        library="SDPA over the rows gathered from the pages outside the "
                "timed region, masked past pos",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q (4,15,64), pools (65,5,16,64) shuffled, tables "
              "(4,16), pos 37/80/123/159")
    # recurrentgemma's paged step: 10 query heads of dh 256 over 1 kv head
    H, K, dh = 10, 1, 256
    q, kp, vp, tb, p = make(pos, torch.bfloat16, 2)
    idx = tb.long()
    kg = kp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    vg = vp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    q4 = q[:, :, None]
    extra_line("decode_attention_paged", "bf16 q (4,10,256), pools "
               "(65,1,16,256) shuffled, tables (4,16), pos 37/80/123/159",
               lambda: dmod.decode_attention_paged(q, kp, vp, tb, p),
               lambda: dmod.plain_paged(q, kp, vp, tb, p),
               lambda: F.scaled_dot_product_attention(
                   q4, kg, vg, attn_mask=valid, enable_gqa=True),
               decode_bound(pos, H, K, dh, NP=NP),
               "SDPA over the gathered rows")
    # arctic-480b's paged step: 56 query heads over 8 kv heads at dh 128
    H, K, dh = 56, 8, 128
    q, kp, vp, tb, p = make(pos, torch.bfloat16, 3)
    idx = tb.long()
    kg = kp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    vg = vp[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    q4 = q[:, :, None]
    extra_line("decode_attention_paged", "bf16 q (4,56,128), pools "
               "(65,8,16,128) shuffled, tables (4,16), pos 37/80/123/159 "
               "(arctic-480b's heads)",
               lambda: dmod.decode_attention_paged(q, kp, vp, tb, p),
               lambda: dmod.plain_paged(q, kp, vp, tb, p),
               lambda: F.scaled_dot_product_attention(
                   q4, kg, vg, attn_mask=valid, enable_gqa=True),
               decode_bound(pos, H, K, dh, NP=NP),
               "SDPA over the gathered rows")


def page_tables(pos, pt: int, np_: int, seed: int, dev):
    """Page tables (B, np_) int32 on ``dev`` for rows at ``pos`` over a
    pool of P = B np_ + 1 pages: row b's pages drawn from a shuffle of
    the first P - 1, entries past its pages on the scratch page P - 1."""
    import torch
    B = len(pos)
    perm = torch.randperm(B * np_,
                          generator=torch.Generator().manual_seed(seed))
    tables = torch.full((B, np_), B * np_, dtype=torch.int32)
    for b, x in enumerate(pos):
        n = min(x // pt + 1, np_)
        tables[b, :n] = perm[b * np_:b * np_ + n].to(torch.int32)
    return tables.to(dev)


def paged_copy(kc, vc, pos, pt: int, seed: int):
    """The slotted caches (B, K, S_max, dh) as shuffled page pools with
    S_max / pt table entries a row (:func:`page_tables`); the pages no
    row names, the scratch page among them, hold zeros.  Returns (k
    pages, v pages, tables)."""
    import torch
    B, K, S_max, dh = kc.shape
    np_ = S_max // pt
    tables = page_tables(pos, pt, np_, seed, kc.device)
    kp = torch.zeros((B * np_ + 1, K, pt, dh), dtype=kc.dtype,
                     device=kc.device)
    vp = torch.zeros_like(kp)
    for b, x in enumerate(pos):
        n = min(x // pt + 1, np_)
        pages = tables[b, :n].long()
        kp[pages] = kc[b, :, :n * pt].unflatten(1, (n, pt)).transpose(0, 1)
        vp[pages] = vc[b, :, :n * pt].unflatten(1, (n, pt)).transpose(0, 1)
    return kp, vp, tables


def check_decode_splits(dev, randn):
    """The decode kernels' split over the cache keeps a row's bits: each
    row of a B = 4 call equals a B = 1 call of that row, a 256-slot cache
    equals a 512-slot one over the same valid rows, and the paged kernel
    equals the slotted one over the same rows (at 16 and at 32 table
    entries a row), at dh 64 and 256, bf16 and f32.  Then both kernels at
    smollm heads over a 2048-row cache (SmolLM-360M's context): held
    against their plain versions in f32 and bf16 and timed in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dmod
    pos = (5, 64, 159, 255)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    for H, K, dh in ((15, 5, 64), (10, 1, 256), (32, 8, 120)):
        for dt in (torch.bfloat16, torch.float32):
            q = randn(4, H, dh, dtype=dt)
            kl = randn(4, K, 512, dh, dtype=dt)
            vl = randn(4, K, 512, dh, dtype=dt)
            kc, vc = kl[:, :, :256].contiguous(), vl[:, :, :256].contiguous()
            full = dmod.decode_attention(q, kc, vc, p)
            rows = torch.cat([dmod.decode_attention(
                q[i:i + 1], kc[i:i + 1], vc[i:i + 1], p[i:i + 1])
                for i in range(4)])
            longer = dmod.decode_attention(q, kl, vl, p)
            kp, vp, tb = paged_copy(kc, vc, pos, 16, dh)
            # the same pages, and 16 more entries on the scratch page
            tb32 = torch.cat([tb, torch.full_like(tb, kp.shape[0] - 1)], 1)
            paged = dmod.decode_attention_paged(q, kp, vp, tb, p)
            paged32 = dmod.decode_attention_paged(q, kp, vp, tb32, p)
            prow = torch.cat([dmod.decode_attention_paged(
                q[i:i + 1], kp, vp, tb[i:i + 1], p[i:i + 1])
                for i in range(4)])
            torch.cuda.synchronize()
            for what, got, want in (
                    ("decode_attention B=4 rows vs B=1", full, rows),
                    ("decode_attention S_max 256 vs 512", full, longer),
                    ("decode_attention_paged vs decode_attention", paged,
                     full),
                    ("decode_attention_paged B=4 rows vs B=1", paged, prow),
                    ("decode_attention_paged 16 vs 32 table entries",
                     paged, paged32)):
                same = torch.equal(got, want)
                print(f"  {what} (H={H} K={K} dh={dh} {str(dt)[6:]}, pos "
                      f"{pos}): {'bit-equal' if same else 'DIFFERS'}")
                need(same, f"{what} differs at dh {dh} {dt}")
    # smollm heads, 4 rows over a 2048-row cache (16 splits a row at the
    # longest), slotted and 16-token pages: held against the plain versions
    # in f32 and bf16, paged against slotted, then timed in bf16
    H, K, dh, S_max = 15, 5, 64, 2048
    pos = (2047, 1535, 1023, 511)
    B, rows = len(pos), sum(x + 1 for x in pos)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    for dt, tol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
        q = randn(B, H, dh, dtype=dt)
        kc = randn(B, K, S_max, dh, dtype=dt)
        vc = randn(B, K, S_max, dh, dtype=dt)
        kp, vp, tb = paged_copy(kc, vc, pos, 16, 0)
        got = dmod.decode_attention(q, kc, vc, p)
        paged = dmod.decode_attention_paged(q, kp, vp, tb, p)
        for what, o, want in (
                ("decode_attention", got, dmod.plain(q, kc, vc, p)),
                ("decode_attention_paged", paged,
                 dmod.plain_paged(q, kp, vp, tb, p))):
            torch.cuda.synchronize()
            e = (o.float() - want.float()).abs().max().item()
            print(f"  {what} B={B} H={H} K={K} dh={dh} S_max={S_max} pos="
                  f"{pos} {str(dt)[6:]}: max abs err {e:.3e} (tol {tol})")
            need(math.isfinite(e) and e <= tol,
                 f"{what} S_max={S_max} {dt} err {e}")
        same = torch.equal(paged, got)
        print(f"  decode_attention_paged vs decode_attention (S_max={S_max} "
              f"{str(dt)[6:]}): {'bit-equal' if same else 'DIFFERS'}")
        need(same, f"decode_attention_paged differs at S_max={S_max} {dt}")
    valid = (torch.arange(S_max, device=dev)[None, :]
             <= p.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    shape = (f"bf16 q (4,15,64), cache (4,5,2048,64), pos "
             f"{'/'.join(map(str, pos))}")
    extra_line("decode_attention", shape,
               lambda: dmod.decode_attention(q, kc, vc, p),
               lambda: dmod.plain(q, kc, vc, p),
               lambda: F.scaled_dot_product_attention(
                   q4, kc, vc, attn_mask=valid, enable_gqa=True),
               decode_bound(pos, H, K, dh), library="SDPA masked past pos")
    extra_line("decode_attention_paged", shape.replace(
                   "cache (4,5,2048,64)", f"pools {tuple(kp.shape)}, 16-token "
                   f"pages shuffled"),
               lambda: dmod.decode_attention_paged(q, kp, vp, tb, p),
               lambda: dmod.plain_paged(q, kp, vp, tb, p),
               lambda: F.scaled_dot_product_attention(
                   q4, kc, vc, attn_mask=valid, enable_gqa=True),
               decode_bound(pos, H, K, dh, NP=tb.shape[1]),
               library="SDPA over the slotted rows, masked past pos")


def check_head_dims(dev, randn):
    """The attention kernels at head dims other than 64, 128 and 256: each
    runs in a padded instance (32, 64, 128 or 256) that reads rows of the
    true dh.  Held against the plain versions, bf16 and f32, at dh 20
    (smollm-360m smoke), 80 (hubert-xlarge, 16 heads, bidirectional) and
    120 (h2o-danube-3-4b, 32 query heads over 8 kv heads): flash attention
    causal, with a window and non-causal; both decode kernels without and
    with a window (a ring of 64 slots), paged bit-equal to slotted.  The
    decode kernels also at dh 128 (yi-9b's 32 over 4 kv heads) with a
    window.  Then the decode step of yi-9b's and h2o-danube's heads over a
    256-row cache timed beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    pos = (5, 37, 159, 255)
    for dh, H, K in ((20, 3, 1), (80, 16, 16), (120, 32, 8), (128, 32, 4),
                     (128, 32, 32)):
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            errs = []
            flash = [] if dh == 128 else [(100, 100, True, 0),
                                          (77, 77, True, 16),
                                          (64, 128, True, 0),
                                          (50, 50, False, 16)]
            for S, T, causal, win in flash:
                q = randn(2, S, H, dh, dtype=dt)
                k = randn(2, T, K, dh, dtype=dt)
                v = randn(2, T, K, dh, dtype=dt)
                got = fmod.flash_attention(q, k, v, causal=causal, window=win)
                want = fmod.plain(q, k, v, causal=causal, window=win)
                torch.cuda.synchronize()
                errs.append((f"flash S={S} T={T} causal={causal} "
                             f"window={win}",
                             (got.float() - want.float()).abs().max().item()))
            for win, s_max in ((0, 256), (64, 64)):
                p = torch.tensor([x if win == 0 else x + 300 for x in pos],
                                 dtype=torch.int32, device=dev)
                q = randn(4, H, dh, dtype=dt)
                kc = randn(4, K, s_max, dh, dtype=dt)
                vc = randn(4, K, s_max, dh, dtype=dt)
                got = dmod.decode_attention(q, kc, vc, p, window=win)
                want = dmod.plain(q, kc, vc, p, window=win)
                kp, vp, tb = paged_copy(kc, vc, p.tolist(), 16, dh)
                paged = dmod.decode_attention_paged(q, kp, vp, tb, p,
                                                    window=win)
                pwant = dmod.plain_paged(q, kp, vp, tb, p, window=win)
                torch.cuda.synchronize()
                errs.append((f"decode window={win}",
                             (got.float() - want.float()).abs().max().item()))
                errs.append((f"paged window={win}",
                             (paged.float() - pwant.float()).abs().max()
                             .item()))
                same = torch.equal(paged, got)
                need(same, f"decode_attention_paged differs from slotted at "
                           f"dh {dh} window {win} {dt}")
            worst = max(e for _, e in errs)
            print(f"  head dim {dh} (H={H} K={K}) {str(dt)[6:]}: max abs err "
                  f"{worst:.3e} (tol {tol}) over "
                  f"{', '.join(w for w, _ in errs)}; paged bit-equal to "
                  f"slotted")
            for what, e in errs:
                need(math.isfinite(e) and e <= tol,
                     f"{what} at dh {dh} {dt}: err {e}")
    # one decode step (B = 1, pos 159 of a 256-row cache) at yi-9b's,
    # h2o-danube-3-4b's and codeqwen1.5-7b's heads: the dh-128 split at
    # rep 8 and rep 1, and dh 120 padded to 128
    t = 159
    p = torch.tensor([t], dtype=torch.int32, device=dev)
    for H, K, dh in ((32, 4, 128), (32, 8, 120), (32, 32, 128),
                     (56, 8, 128)):
        q = randn(1, H, dh, dtype=torch.bfloat16)
        kc = randn(1, K, 256, dh, dtype=torch.bfloat16)
        vc = randn(1, K, 256, dh, dtype=torch.bfloat16)
        q4 = q[:, :, None]
        extra_line("decode_attention", f"bf16 q (1,{H},{dh}), cache "
                   f"(1,{K},256,{dh}), pos {t}, split "
                   f"{dmod.plan(K, H // K, dh)}",
                   lambda: dmod.decode_attention(q, kc, vc, p),
                   lambda: dmod.plain(q, kc, vc, p),
                   lambda: F.scaled_dot_product_attention(
                       q4, kc[:, :, :t + 1], vc[:, :, :t + 1],
                       enable_gqa=True),
                   decode_bound((t,), H, K, dh),
                   library="SDPA over the valid rows, enable_gqa")
    # the decode step past a 4096-token window: position 5119 over the
    # 4096-slot ring, every slot in the window (h2o-danube-3-4b's request
    # in phase 31 at dh 120, mixtral-8x7b's in phase 32 at dh 128)
    W, t = 4096, 5119
    p = torch.tensor([t], dtype=torch.int32, device=dev)
    for H, K, dh in ((32, 8, 120), (32, 8, 128)):
        for dt, tol in ((torch.float32, F32_ATOL),
                        (torch.bfloat16, BF16_ATOL)):
            q = randn(1, H, dh, dtype=dt)        # bf16 last: timed below
            kc = randn(1, K, W, dh, dtype=dt)
            vc = randn(1, K, W, dh, dtype=dt)
            got = dmod.decode_attention(q, kc, vc, p, window=W)
            want = dmod.plain(q, kc, vc, p, window=W)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"  decode_attention H={H} K={K} dh={dh} ring {W} pos {t} "
                  f"window {W} {str(dt)[6:]}: max abs err {e:.3e} (tol "
                  f"{tol})")
            need(math.isfinite(e) and e <= tol,
                 f"decode_attention over the {W}-slot ring dh {dh} {dt} "
                 f"err {e}")
        q4 = q[:, :, None]
        extra_line("decode_attention", f"bf16 q (1,{H},{dh}), ring "
                   f"(1,{K},{W},{dh}), pos {t}, window {W}",
                   lambda: dmod.decode_attention(q, kc, vc, p, window=W),
                   lambda: dmod.plain(q, kc, vc, p, window=W),
                   lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                          enable_gqa=True),
                   decode_bound((W - 1,), H, K, dh),
                   library="SDPA over the whole ring, enable_gqa")


def ssd_fwd_bounds(b: int, nh: int, S: int, dp: int, N: int) -> tuple:
    """The least time of ``ssd_scan`` at bf16 x (b, nh, S, dp), N, from the
    package's ``ssd_scan.cost`` (as the backward's from ``cost_bwd``):
    ((ms, by), {name: (ms, by)}).  Bytes: x and y (bf16), dt, A, B, C
    (f32), each once.  Operations: the chunked form's products at the bf16
    rate in the plan's chunks of L steps (``ssd_scan.fwd_products``: C B^T
    once a batch row and chunk, the intra product, the state update in
    three bf16 pieces and the inter term in two); the least time is the
    larger of the bytes' and these products'.  Beside them the design's
    own count (each of a (batch, head)'s dp / cols blocks recomputes C
    B^T) and the sequential form's f32 count (5 dp N a step and head)."""
    import torch
    from repro_torch.kernels import ssd_scan as smod
    L, cols = smod.plan(dp, N, torch.bfloat16)
    flops, nbytes = smod.cost(*ssd_meta(b, nh, S, dp, N))
    design = 2 * smod.fwd_products(b, nh, S, dp, N, L, cols)
    counts = {"bytes": bound(nbytes, 0, torch.bfloat16),
              f"chunked bf16 products, L {L}": bound(0, flops,
                                                     torch.bfloat16),
              f"the design's products (C B^T in each of dp / {cols} "
              f"blocks)": bound(0, design, torch.bfloat16),
              "sequential f32 count": bound(0, 5 * b * nh * S * dp * N,
                                            torch.float32)}
    return bound(nbytes, flops, torch.bfloat16), counts


def ssd_meta(b: int, nh: int, S: int, dp: int, N: int) -> tuple:
    """Meta tensors of an ``ssd_scan`` call's shapes: bf16 x, f32 dt, A,
    B, C (what ``cost`` reads)."""
    import torch

    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (m(b, nh, S, dp, dtype=torch.bfloat16), m(b, nh, S), m(nh),
            m(b, S, N), m(b, S, N))


def check_scans(dev, report: dict, randn, g):
    """ssd_scan and rglru_scan against their plain (sequential) versions:
    at the path shapes, at a multi-chunk S that the chunk does not divide,
    at B = 2 and from a non-zero initial state (final state held too).
    Then their invariants: the rows of a B = 2 call bit-equal to B = 1
    calls, and a call padded with trailing zero steps bit-equal to the
    unpadded one on the valid steps and in the final state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.kernels import ssd_scan as smod

    def ssd_inputs(b, nh, S, dp, N, dt_):
        return (randn(b, nh, S, dp, dtype=dt_),
                randn(b, nh, S).abs() * 0.1 + 0.01,
                -randn(nh).abs() - 0.1,
                randn(b, S, N) * 0.3, randn(b, S, N) * 0.3)

    err = 0.0
    # (b, nh, S, dp, N, bc, h0): the path shape (S 128, chunk 128), a
    # 300-step prompt over chunks of 128, two batch rows, a carried state
    for (b, nh, S, dp, N, bc, with_h0) in [
            (1, 48, 128, 64, 128, 128, False), (1, 48, 300, 64, 128, 128, False),
            (2, 8, 100, 64, 128, 128, True), (1, 4, 37, 16, 16, 16, True)]:
        for dt_, tol in ((torch.bfloat16, BF16_ATOL),
                         (torch.float32, F32_ATOL)):
            x, dt, A, B, C = ssd_inputs(b, nh, S, dp, N, dt_)
            h0 = randn(b, nh, dp, N) * 0.5 if with_h0 else None
            y, hS = ops.ssd_scan(x, dt, A, B, C, bc=bc, h0=h0,
                                 return_state=True)
            y_p, h_p = smod.plain(x, dt, A, B, C, h0=h0, return_state=True)
            torch.cuda.synchronize()
            e, eh = rel_err(y, y_p), rel_err(hS, h_p)
            err = max(err, (y.float() - y_p.float()).abs().max().item())
            print(f"  ssd_scan b={b} nh={nh} S={S} dp={dp} N={N} bc={bc} "
                  f"h0={with_h0} {str(dt_)[6:]}: max err {e:.3e}, final "
                  f"state {eh:.3e} of max |out| (tol {tol})")
            need(y.dtype == dt_ and math.isfinite(e) and e <= tol and
                 eh <= F32_ATOL * (1 if dt_ == torch.float32 else 10),
                 f"ssd_scan S={S} {dt_} err {e}, state err {eh}")
    # main-path timing shape: one mamba2-780m SSD block of a 128-token
    # prefill; the bound is the package's count (the bytes and the chunked
    # form's bf16 products), the other counts beside it
    b, nh, S, dp, N = 1, 48, 128, 64, 128
    x, dt, A, B, C = ssd_inputs(b, nh, S, dp, N, torch.bfloat16)
    (b_ms, b_by), bounds = ssd_fwd_bounds(b, nh, S, dp, N)
    print("  ssd_scan bounds at (1,48,128,64): " + "; ".join(
        f"{k} {ms:.6f} ms ({by})" for k, (ms, by) in bounds.items()))
    report["ssd_scan"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: smod.ssd_scan(x, dt, A, B, C)),
        call_ms=call_ms(lambda: smod.ssd_scan(x, dt, A, B, C)),
        plain_ms=device_ms(lambda: smod.plain(x, dt, A, B, C)),
        library_ms=None,
        library="none: no single PyTorch call computes the SSD scan",
        bound_ms=b_ms, bound_by=b_by,
        bounds={k: {"bound_ms": ms, "bound_by": by}
                for k, (ms, by) in bounds.items()},
        shape="bf16 x (1,48,128,64), f32 dt (1,48,128), B/C (1,128,128)")
    # mamba2-780m's training shape (batch 8 of 512 steps), the forward of
    # phase 28's steps: bound as the backward's (bytes and the chunked
    # form's bf16 products), the plain scan beside it
    b, S = 8, 512
    x, dt, A, B, C = ssd_inputs(b, nh, S, dp, N, torch.bfloat16)
    bnd, bounds = ssd_fwd_bounds(b, nh, S, dp, N)
    print("  ssd_scan bounds at (8,48,512,64): " + "; ".join(
        f"{k} {ms:.6f} ms ({by})" for k, (ms, by) in bounds.items()))
    extra_line("ssd_scan", "bf16 x (8,48,512,64), f32 dt (8,48,512), B/C "
               "(8,512,128)", lambda: smod.ssd_scan(x, dt, A, B, C),
               lambda: smod.plain(x, dt, A, B, C), None, bnd,
               library="none")

    err = 0.0
    for (Bz, S, W, bc, with_h0) in [(1, 128, 2560, 256, False),
                                    (1, 300, 2560, 128, False),
                                    (2, 100, 2560, 256, True),
                                    (2, 37, 300, 16, True)]:
        for dt_, tol in ((torch.bfloat16, BF16_ATOL),
                         (torch.float32, F32_ATOL)):
            a = (torch.rand(Bz, S, W, generator=g, device=dev) * 0.5
                 + 0.5).to(dt_)
            bb = randn(Bz, S, W, dtype=dt_)
            h0 = randn(Bz, W) if with_h0 else None
            y, hS = ops.rglru_scan(a, bb, bc=bc, h0=h0, return_state=True)
            y_p, h_p = rmod.plain(a, bb, h0=h0, return_state=True)
            torch.cuda.synchronize()
            e, eh = rel_err(y, y_p), rel_err(hS, h_p)
            err = max(err, (y.float() - y_p.float()).abs().max().item())
            print(f"  rglru_scan B={Bz} S={S} W={W} bc={bc} h0={with_h0} "
                  f"{str(dt_)[6:]}: max err {e:.3e}, final state {eh:.3e} "
                  f"of max |out| (tol {tol})")
            need(y.dtype == dt_ and math.isfinite(e) and e <= tol and
                 eh <= F32_ATOL, f"rglru_scan S={S} {dt_} err {e}, state "
                 f"err {eh}")
    # main-path timing shape: one recurrentgemma-2b RG-LRU block of a
    # 128-token prefill (the gates are f32)
    Bz, S, W = 1, 128, 2560
    a = torch.rand(Bz, S, W, generator=g, device=dev) * 0.5 + 0.5
    bb = randn(Bz, S, W)
    b_ms, b_by = cost_bound("rglru_scan", a, bb, peak=torch.float32)
    check_scan_rows(dev, randn, g)
    report["rglru_scan"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: rmod.rglru_scan(a, bb)),
        call_ms=call_ms(lambda: rmod.rglru_scan(a, bb)),
        plain_ms=device_ms(lambda: rmod.plain(a, bb)),
        library_ms=None,
        library="none: no single PyTorch call computes a first-order "
                "linear recurrence",
        bound_ms=b_ms, bound_by=b_by,
        shape="f32 a, b (1,128,2560)")


def check_scan_rows(dev, randn, g):
    """The scans' rows do not depend on the batch or on trailing padding:
    each row of a B = 2 call equals a B = 1 call of that row, and a call
    whose S is padded with zero steps (dt = 0 for ssd_scan, a = b = 0 for
    rglru_scan, past a whole extra chunk) equals the unpadded call on the
    valid steps, final state included, bit for bit, bf16 and f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.kernels import ssd_scan as smod
    b, nh, S, dp, N, pad = 2, 8, 100, 64, 128, 100
    for dt_ in (torch.bfloat16, torch.float32):
        x = randn(b, nh, S, dp, dtype=dt_)
        dt = randn(b, nh, S).abs() * 0.1 + 0.01
        A = -randn(nh).abs() - 0.1
        B, C = randn(b, S, N) * 0.3, randn(b, S, N) * 0.3
        h0 = randn(b, nh, dp, N) * 0.5
        y, hS = smod.ssd_scan(x, dt, A, B, C, h0=h0, return_state=True)
        ones = [smod.ssd_scan(x[i:i + 1], dt[i:i + 1], A, B[i:i + 1],
                              C[i:i + 1], h0=h0[i:i + 1], return_state=True)
                for i in range(b)]
        yp, hp = smod.ssd_scan(
            F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, pad)), A,
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)), h0=h0,
            return_state=True)
        torch.cuda.synchronize()
        rows = torch.equal(y, torch.cat([o[0] for o in ones])) and \
            torch.equal(hS, torch.cat([o[1] for o in ones]))
        padded = torch.equal(yp[:, :, :S], y) and torch.equal(hp, hS)
        print(f"  ssd_scan b={b} nh={nh} S={S} dp={dp} N={N} "
              f"{str(dt_)[6:]}: B=2 rows {'bit-equal' if rows else 'DIFFER'}"
              f" to B=1; padded to S={S + pad} "
              f"{'bit-equal' if padded else 'DIFFERS'} on the valid steps")
        need(rows, f"ssd_scan rows depend on the batch ({dt_})")
        need(padded, f"ssd_scan valid steps depend on padding ({dt_})")
    Bz, S, W, pad = 2, 100, 2560, 156
    for dt_ in (torch.bfloat16, torch.float32):
        a = (torch.rand(Bz, S, W, generator=g, device=dev) * 0.5 + 0.5).to(dt_)
        bb = randn(Bz, S, W, dtype=dt_)
        h0 = randn(Bz, W)
        y, hS = rmod.rglru_scan(a, bb, h0=h0, return_state=True)
        ones = [rmod.rglru_scan(a[i:i + 1], bb[i:i + 1], h0=h0[i:i + 1],
                                return_state=True) for i in range(Bz)]
        yp, hp = rmod.rglru_scan(F.pad(a, (0, 0, 0, pad)),
                                 F.pad(bb, (0, 0, 0, pad)), h0=h0,
                                 return_state=True, n_valid=S)
        torch.cuda.synchronize()
        rows = torch.equal(y, torch.cat([o[0] for o in ones])) and \
            torch.equal(hS, torch.cat([o[1] for o in ones]))
        padded = torch.equal(yp[:, :S], y) and torch.equal(hp, hS)
        print(f"  rglru_scan B={Bz} S={S} W={W} {str(dt_)[6:]}: B=2 rows "
              f"{'bit-equal' if rows else 'DIFFER'} to B=1; padded to "
              f"S={S + pad} {'bit-equal' if padded else 'DIFFERS'} on the "
              f"valid steps")
        need(rows, f"rglru_scan rows depend on the batch ({dt_})")
        need(padded, f"rglru_scan valid steps depend on padding ({dt_})")


def check_rmsnorm(dev, report: dict, randn):
    """rmsnorm against its plain version (bf16 and f32, scales in either;
    at the configs' widths up to mixtral's d 4096, arctic's 7168 and
    internvl2's 8192, and training's (8,512,960)), rows bit-equal at M in
    {1, 4, 16} to one-row calls at d 960, 2560 and 8192, and timed at a
    recurrentgemma-2b decode step's norm (B = 4, d 2560, bf16)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as nmod
    err = 0.0
    shapes = ((4, 1, 2560), (1, 128, 2560), (3, 7, 3072), (5, 960),
              (2, 3, 20), (4, 1, 4096), (4, 1, 8192), (8, 512, 960),
              (3, 1536), (2, 5, 3840), (3, 7168))
    for shape in shapes:
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            for sdt in (torch.float32, torch.bfloat16):
                x = randn(*shape, dtype=dt) * 3
                sc = (randn(shape[-1]) * 0.1).to(sdt)
                got = nmod.rmsnorm(x, sc)
                want = nmod.plain(x, sc)
                torch.cuda.synchronize()
                e = rel_err(got, want)
                err = max(err, (got.float() - want.float()).abs().max()
                          .item())
                need(got.dtype == dt and math.isfinite(e) and e <= tol,
                     f"rmsnorm {shape} {dt} scale {sdt}: err {e}")
    print(f"  rmsnorm {' '.join(str(s).replace(' ', '') for s in shapes)}, "
          f"bf16 and f32, f32 and bf16 scales: max abs err {err:.3e} "
          f"(tol {BF16_ATOL} / {F32_ATOL} of max |out|)")
    for d, sdt in ((960, torch.float32), (8192, torch.bfloat16),
                   (2560, torch.bfloat16)):
        x = randn(16, 1, d, dtype=torch.bfloat16) * 3
        sc = (randn(d) * 0.1).to(sdt)
        rows = torch.cat([nmod.rmsnorm(x[i:i + 1], sc) for i in range(16)])
        for m in (1, 4, 16):
            same = torch.equal(nmod.rmsnorm(x[:m], sc), rows[:m])
            print(f"  rmsnorm row independence (d {d}, bf16) M={m}: "
                  f"{'bit-equal' if same else 'DIFFERS'} to M=1")
            need(same, f"rmsnorm rows depend on M at M={m}, d {d}")
    x = x[:4]
    w = (1.0 + sc.float()).to(torch.bfloat16)      # outside the timed region
    d = 2560
    b_ms, b_by = cost_bound("rmsnorm", x, sc, peak=torch.float32)
    report["rmsnorm"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: nmod.rmsnorm(x, sc)),
        call_ms=call_ms(lambda: nmod.rmsnorm(x, sc)),
        plain_ms=device_ms(lambda: nmod.plain(x, sc)),
        library_ms=device_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
        library="F.rms_norm with weight 1 + scale made outside the timed "
                "region",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 x (4,1,2560), bf16 scale (2560,)")


# ---------------------------------------------------------------------------
# phases 4-5: cold starts (cast, dequant, pisel) and greedy generation
# ---------------------------------------------------------------------------

def deploy_smollm(workdir: str):
    """Phase 4's stores: smollm-360m at full width, random weights from
    seed 0 (a CPU generator a unit), as ``smollm`` (f32) and
    ``smollm-int8`` under ``<workdir>/store`` at 2000 MB/s."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.store.store import (BandwidthModel, WeightStore,
                                         deploy_model)
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    cpu_model = transformer.build(cfg, device="cpu")
    units = {}
    for i, name in enumerate(cpu_model.unit_names()):
        gen = torch.Generator().manual_seed(transformer.unit_seed(0, i))
        units[name] = cpu_model.init_unit(name, gen)
    store = WeightStore(os.path.join(workdir, "store"),
                        BandwidthModel(bandwidth_mbps=2000))
    deploy_model(store, cpu_model, "smollm", params_by_unit=units)
    deploy_model(store, cpu_model, "smollm-int8", quant="int8",
                 params_by_unit=units)
    plat = deploy_platform_store(workdir, "smollm-360m", units)
    del units
    print(f"  deployed smollm-360m ({cfg.param_count() / 1e6:.1f} M params) "
          f"f32 {store.model_nbytes('smollm') / 1e9:.3f} GB, int8 "
          f"{store.model_nbytes('smollm-int8') / 1e9:.3f} GB, and {plat} "
          f"in {time.perf_counter() - t0:.1f} s (set-up)")
    return store


def cold_starts(dev, workdir: str):
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving.api import GenerateSpec
    from repro_torch.serving.decode import sample_first

    cfg = get_config("smollm-360m")
    model = transformer.build(cfg)
    store = deploy_smollm(workdir)

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    spec = GenerateSpec(prompt=prompt[0], n_new=1)
    results = {}
    loads = [("cicada f32 store, apply_dtype=bf16 (cast)", "smollm",
              "cicada", torch.bfloat16),
             ("cicada int8 store (dequant)", "smollm-int8", "cicada", None),
             ("pisel f32 store", "smollm", "pisel", None)]
    for label, store_name, strat, adt in loads:
        eng = ColdStartEngine(model, store_name, store, strategy=strat,
                              apply_dtype=adt)
        eng.warmup(batch)
        first = []
        before = ops.registry.dispatch_snapshot()
        res = eng.load(batch, on_logits=lambda lg: first.append(
            (sample_first(lg, spec, 128), time.monotonic())))
        after = ops.registry.dispatch_snapshot()
        launched = {k: after[k] - before[k] for k in after}
        tr = res.trace
        need(len(first) == 1, f"{label}: on_logits did not fire once")
        e_final = tr.events_for("E")["final"]
        need(e_final.t_start <= first[0][1] <= e_final.t_end,
             f"{label}: first token not sampled inside the final E")
        logits = res.logits
        need(tuple(logits.shape) == (1, 128, cfg.vocab_size) and
             bool(torch.isfinite(logits.float()).all()),
             f"{label}: logits {tuple(logits.shape)} not finite/shaped")
        warm, _ = model.forward(res.params, batch_dev(batch, dev))
        diff = (warm.float() - logits.float()).abs().max().item()
        scale = logits.float().abs().max().item()
        print(f"\n  {label}: load {tr.total_time() * 1e3:.1f} ms, "
              f"utilization {tr.utilization():.1%}, first token "
              f"{first[0][0]} at {(first[0][1] - tr.t0) * 1e3:.1f} ms, "
              f"warm forward vs in-pipeline logits max abs "
              f"diff {diff:.3e} (max |logit| {scale:.3f}), kernel launches "
              f"{launched}")
        summ = tr.summary()
        print("  stage work (s): " + ", ".join(
            f"{k[5:]} {summ[k]:.3f}" for k in ("work_L", "work_R", "work_A",
                                               "work_E"))
              + f"; waits (s): A {summ['wait_A']:.3f}, E {summ['wait_E']:.3f}")
        print(tr.render_gantt(100))
        need(diff <= BF16_ATOL * max(1.0, scale),
             f"{label}: warm forward differs from in-pipeline logits")
        results[label] = res
    a = results[loads[0][0]].logits.float()
    b = results[loads[2][0]].logits.float()
    d = (a - b).abs().max().item()
    print(f"\n  cicada (bf16 cast at A) vs pisel (cast at use): max abs diff "
          f"{d:.3e}")
    need(d <= BF16_ATOL * max(1.0, b.abs().max().item()),
         "cicada and pisel loads of one store disagree")
    return dict(model=model, cfg=cfg, store=store, prompt=prompt,
                batch=batch, cast=results[loads[0][0]],
                dequant=results[loads[1][0]])


def f32_oracle(dev, cs: dict):
    """The f32 oracle of the int8 store: its dequantized weights with f32
    compute (phase 6 measures the bf16 loads' error against it).  A check,
    so it runs outside every path's count window."""
    import torch
    from repro_torch.models import transformer
    f32_model = transformer.build(dataclasses.replace(
        cs["cfg"], compute_dtype=torch.float32))
    oracle, _ = f32_model.forward(cs["dequant"].params,
                                  batch_dev(cs["batch"], dev))
    return oracle.float()


def batch_dev(batch, dev):
    return {k: v.to(dev) for k, v in batch.items()}


def generate(model, params, cfg):
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.decode import reference_generate
    import torch

    rng = np.random.default_rng(1)
    out = {}
    for S in (37, 64, 100, 128):
        prompt = rng.integers(0, cfg.vocab_size, (S,))
        before = ops.registry.dispatch_snapshot()
        t0 = time.perf_counter()
        toks = reference_generate(model, params, prompt, n_new=32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = ops.registry.dispatch_snapshot()
        delta = {k: after[k] - before[k] for k in after}
        need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
             f"prompt {S}: bad tokens {toks}")
        print(f"  prompt {S}: 32 greedy tokens in {dt * 1e3:.1f} ms "
              f"(host clock, prefill + 31 decode steps), launches {delta}: "
              f"{toks}")
        out[S] = toks
    return out


def param_bytes(params) -> int:
    from repro_torch import tree as tree_util
    from repro_torch.quant import QuantLeaf
    return sum(l.nbytes if isinstance(l, QuantLeaf)
               else l.numel() * l.element_size()
               for l in tree_util.leaves(params))


# ---------------------------------------------------------------------------
# phase 6: the int8-resident cold start
# ---------------------------------------------------------------------------

def hold_to_oracle(label: str, logits, deq, oracle, first: int,
                   deq_label: str = "dequant-at-A"):
    """An int8-resident load's logits against the f32 oracle of its int8
    store, beside the dequant-at-A load's.  bf16 compute drifts from f32
    with depth (the residual stream is rounded after every block; the JAX
    package drifts alike, see tests/test_torch_quant.py), so the two loads
    are not held to each other: the dequant-at-A load's error is the noise
    floor of this depth, and the int8-resident load, whose weights are not
    rounded to bf16, may exceed it by a tenth at most.  Its greedy first
    token is the oracle's, or the oracle's top two are within the bf16
    noise."""
    import torch
    scale = oracle.abs().max().item()
    e_deq = (deq - oracle).abs().max().item() / scale
    e_q = (logits - oracle).abs().max().item() / scale
    d = (logits - deq).abs().max().item()
    top = torch.topk(oracle[0, -1], 2)
    margin = (top.values[0] - top.values[1]).item()
    n = oracle.shape[1]
    agree = {k: int((v.argmax(-1) == oracle.argmax(-1)).sum())
             for k, v in ((label, logits), (deq_label, deq))}
    print(f"  logits against the f32 oracle (max |logit| {scale:.3f}): "
          f"{label} {e_q:.3e}, {deq_label} {e_deq:.3e} relative (limit "
          f"1.1 x {e_deq:.3e}); {label} vs {deq_label} max abs diff "
          f"{d:.3e}; argmax equal to the oracle's at {agree} of {n} "
          f"positions; first token {first}, oracle {int(top.indices[0])} "
          f"(top-two margin {margin:.3e})")
    need(e_q <= 1.1 * e_deq,
         f"{label} logits {e_q:.3e} from the f32 oracle, beyond 1.1 x the "
         f"{deq_label}'s {e_deq:.3e}")
    need(first == int(top.indices[0]) or margin <= 2 * e_deq * scale,
         f"{label} first token {first} is not the oracle's "
         f"{int(top.indices[0])}, whose margin {margin:.3e} is beyond the "
         f"bf16 noise")


def quant_cold_start(dev, cs: dict):
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.api import GenerateSpec
    from repro_torch.serving.decode import sample_first

    model, cfg, batch = cs["model"], cs["cfg"], cs["batch"]
    spec = GenerateSpec(prompt=cs["prompt"][0], n_new=1)
    eng = ColdStartEngine(model, "smollm-int8", cs["store"],
                          strategy="cicada", compute_quant=True)
    eng.warmup(batch)
    first = []
    before = ops.registry.dispatch_snapshot()
    res = eng.load(batch, on_logits=lambda lg: first.append(
        (sample_first(lg, spec, 128), time.monotonic())))
    after = ops.registry.dispatch_snapshot()
    launched = {k: after[k] - before[k] for k in after}
    tr = res.trace
    need(len(first) == 1, "int8-resident: on_logits did not fire once")
    e_final = tr.events_for("E")["final"]
    need(e_final.t_start <= first[0][1] <= e_final.t_end,
         "int8-resident: first token not sampled inside the final E")
    logits = res.logits
    need(tuple(logits.shape) == (1, 128, cfg.vocab_size) and
         bool(torch.isfinite(logits.float()).all()),
         "int8-resident: logits not finite/shaped")
    need(launched["quant_matmul"] == 7 * cfg.n_layers + 1,
         f"int8-resident load launched quant_matmul "
         f"{launched['quant_matmul']} times, not {7 * cfg.n_layers + 1}")
    need(launched["weight_transform"] == 0,
         f"int8-resident load launched weight_transform "
         f"{launched['weight_transform']} times")
    cast = cs["cast"]
    summ, csumm = tr.summary(), cast.trace.summary()
    qb, cb = param_bytes(res.params), param_bytes(cast.params)
    print(f"  load {tr.total_time() * 1e3:.1f} ms (bf16-cast load "
          f"{cast.trace.total_time() * 1e3:.1f} ms), first token "
          f"{first[0][0]} at {(first[0][1] - tr.t0) * 1e3:.1f} ms, "
          f"utilization {tr.utilization():.1%} (bf16-cast "
          f"{cast.trace.utilization():.1%}), kernel launches in the load "
          f"{launched}")
    print("  stage work (s): " + ", ".join(
        f"{k[5:]} {summ[k]:.3f} (bf16-cast {csumm[k]:.3f})"
        for k in ("work_L", "work_R", "work_A", "work_E")))
    print(f"  resident params {qb / 1e6:.1f} MB against {cb / 1e6:.1f} MB "
          f"for the bf16-cast load ({qb / cb:.3f}x)")
    print(tr.render_gantt(100))
    hold_to_oracle("int8-resident", logits.float(),
                   cs["dequant"].logits.float(), cs["oracle"], first[0][0])
    return res.params, first[0]


# ---------------------------------------------------------------------------
# phases 7-8: the continuous-batching scheduler, slotted and paged
# ---------------------------------------------------------------------------

def first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def margin_ok(model, params, prompt, want, got, tol: float,
              what: str, extra=None) -> bool:
    """Tokens equal, or the first difference is at a near-tie: the
    top-two logit margin there (forward on ``model``, with the batch's
    ``extra`` inputs, a VLM's image rows) is within ``tol`` of max
    |logit|."""
    import numpy as np
    import torch
    i = first_diff(want, got)
    if i is None:
        return True
    seq = torch.as_tensor(np.concatenate([np.asarray(prompt), want[:i]]),
                          device=model.device)[None]
    lg, _ = model.forward(params, {"tokens": seq, **batch_dev(
        extra or {}, model.device)})
    top = torch.topk(lg[0, -1].float(), 2).values
    margin = (top[0] - top[1]).item()
    limit = tol * lg.float().abs().max().item()
    print(f"  {what}: first differing token at position {i}: logit margin "
          f"{margin:.3e} (limit {limit:.3e})")
    return margin <= limit


def step_ms(results) -> dict:
    """Host-clock ms per step by occupancy, from the emission times: all
    tokens of one step share one time stamp; a step's length is the gap
    since the previous step."""
    import collections
    count = collections.Counter(t for r in results
                                for t in r.token_times[1:])
    ts = sorted(count)
    gaps = collections.defaultdict(list)
    for a, b in zip(ts, ts[1:]):
        gaps[count[b]].append((b - a) * 1e3)
    return {occ: sorted(v)[len(v) // 2] for occ, v in sorted(gaps.items())}


def run_concurrent(sched, specs, firsts):
    import threading
    out = [None] * len(specs)
    errs = []

    def run(i):
        try:
            f = firsts.get(i)
            out[i] = sched.generate(
                specs[i], first_token=None if f is None else f[0],
                t_first=None if f is None else f[1])
        except BaseException as e:          # reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def scheduler_slotted(cs: dict, params_q, first):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                     reference_generate)

    model, cfg = cs["model"], cs["cfg"]
    base = cs["prompt"][0]                  # the cold start's 128 tokens
    prompts = [base[:n] for n in (37, 64, 100, 128)]
    specs = [GenerateSpec(prompt=p, n_new=32) for p in prompts]
    sched = DecodeScheduler(model, params_q, n_slots=4, cache_len=256)
    need(set(sched.kernel_modes().values()) == {"cuda"},
         f"scheduler kernel modes {sched.kernel_modes()}")
    ops.registry.reset_counts()
    t0 = time.perf_counter()
    solo = sched.generate(specs[0])
    t1 = time.perf_counter()
    results = run_concurrent(sched, specs, {3: first})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.registry.dispatch_snapshot()
    st = sched.stats()
    ms1, ms4 = step_ms([solo]), step_ms(results)
    print(f"  one request alone: 32 tokens in {(t1 - t0) * 1e3:.1f} ms; "
          f"four concurrent: {(t2 - t1) * 1e3:.1f} ms; {st['steps']} steps "
          f"in all, max occupancy {st['max_occupancy']}")
    print(f"  ms per step by occupancy (host clock, median): alone "
          f"{ms1}, concurrent {ms4}")
    print(f"  kernel launches: {launches}")
    need(st["max_occupancy"] == 4 and st["active"] == 0,
         f"slotted scheduler stats {st}")
    need(launches["decode_attention"] == cfg.n_layers * st["steps"],
         f"decode_attention launched {launches['decode_attention']} times "
         f"in {st['steps']} steps")
    need(solo.tokens == results[0].tokens,
         f"prompt 37's tokens changed between occupancy 1 and 4 (first "
         f"difference at {first_diff(solo.tokens, results[0].tokens)})")
    check_tokens("slotted", prompts, [r.tokens for r in results],
                 [reference_generate(model, params_q, p, n_new=32)
                  for p in prompts])
    need(results[3].tokens[0] == first[0],
         "the resumed request did not keep its in-pipeline first token")
    return {"launches": launches, "tokens": [r.tokens for r in results],
            "prompts": prompts, "ms": (ms1, ms4), "steps": st["steps"]}


def scheduler_paged(cs: dict, params_q, first, slotted: dict):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeScheduler, GenerateSpec

    model, cfg = cs["model"], cs["cfg"]
    prompts = slotted["prompts"]
    specs = [GenerateSpec(prompt=p, n_new=32) for p in prompts]
    sched = DecodeScheduler(model, params_q, n_slots=4, cache_len=256,
                            kv_page_tokens=16)
    ops.registry.reset_counts()
    t0 = time.perf_counter()
    # the 128-token request first: it publishes the shared prefix pages
    lead = sched.generate(specs[3], first_token=first[0], t_first=first[1])
    t1 = time.perf_counter()
    rest = run_concurrent(sched, specs[:3], {})
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.registry.dispatch_snapshot()
    st = sched.stats()
    results = rest + [lead]
    print(f"  128-token request alone: {(t1 - t0) * 1e3:.1f} ms; then 37/64"
          f"/100 concurrent: {(t2 - t1) * 1e3:.1f} ms; {st['steps']} steps,"
          f" prefix hits {st['kv_prefix_hits']} pages, misses "
          f"{st['kv_prefix_misses']}, pages used {st['kv_pages_used']} of "
          f"{st['kv_pages_total']}")
    print(f"  ms per step by occupancy (host clock, median): alone "
          f"{step_ms([lead])}, concurrent {step_ms(rest)}")
    print(f"  kernel launches: {launches}")
    need(st["kv_prefix_hits"] > 0, f"no prefix hits: {st}")
    need(st["kv_pages_pinned"] == 0 and st["active"] == 0,
         f"paged scheduler left pages pinned: {st}")
    need(launches["decode_attention_paged"] == cfg.n_layers * st["steps"],
         f"decode_attention_paged launched "
         f"{launches['decode_attention_paged']} times in {st['steps']} "
         f"steps")
    sched.kvpool.check_invariants()
    check_tokens("paged", prompts, [r.tokens for r in results],
                 slotted["tokens"], "the slotted run's")
    return {"launches": launches, "ms": (step_ms([lead]), step_ms(rest)),
            "steps": st["steps"]}


def run_scheduler(model, params, prompts, first, per_fwd, per_step,
                  label: str, pages=None, extra=(), cache_len: int = 256,
                  n_new: int = 32) -> dict:
    """Four requests through the scheduler, slotted or with ``pages``-token
    pages (prompt 37 alone first, its tokens then equal at occupancy 4;
    then all four together, the 128-token one resuming from
    the load's in-pipeline first token, beside the ``extra`` specs, which
    join as slots free), ``n_new`` tokens each, with exact launch counts;
    a paged run leaves no
    page pinned and its pool's invariants hold.  Returns the tokens (the
    four's, then the extras'), the launches and the ms per step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeScheduler, GenerateSpec
    specs = [GenerateSpec(prompt=p, n_new=n_new) for p in prompts] + list(
        extra)
    sched = DecodeScheduler(model, params, n_slots=4, cache_len=cache_len,
                            kv_page_tokens=pages)
    need(set(sched.kernel_modes().values()) == {"cuda"},
         f"scheduler kernel modes {sched.kernel_modes()}")
    before = ops.registry.dispatch_snapshot()
    t1 = time.perf_counter()
    alone = sched.generate(specs[0])
    t2 = time.perf_counter()
    results = run_concurrent(sched, specs, {3: first})
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st = sched.stats()
    got = delta(before)
    want = {k: (1 + len(specs)) * per_fwd.get(k, 0)
            + st["steps"] * per_step.get(k, 0)
            for k in set(per_fwd) | set(per_step)}
    need_counts(got, want, f"{label} scheduler")
    ms1, ms4 = step_ms([alone]), step_ms(results)
    kv = "" if pages is None else (
        f"; {pages}-token pages of {model.kv_page_bytes(pages)} B, "
        f"{st['kv_pages_used']} of {st['kv_pages_total']} used, "
        f"{st['kv_pages_pinned']} pinned, prefix hits "
        f"{st['kv_prefix_hits']}")
    print(f"  scheduler, {label}: one request alone {n_new} tokens in "
          f"{(t2 - t1) * 1e3:.1f} ms; {len(specs)} concurrent "
          f"{(t3 - t2) * 1e3:.1f} "
          f"ms; {st['steps']} steps, max occupancy {st['max_occupancy']}; "
          f"ms per step by occupancy (host clock, median): alone {ms1}, "
          f"concurrent {ms4}; launches {nonzero(got)}{kv}")
    need(st["max_occupancy"] == 4 and st["active"] == 0,
         f"{label} scheduler stats {st}")
    if pages is not None:
        need(st["kv_pages_pinned"] == 0,
             f"{label} scheduler left pages pinned: {st}")
        sched.kvpool.check_invariants()
    need(results[3].tokens[0] == first[0],
         f"{label}: the resumed request did not keep its first token")
    need(alone.tokens == results[0].tokens,
         f"{label}: prompt 37's tokens changed between occupancy 1 and 4 "
         f"(first difference at "
         f"{first_diff(alone.tokens, results[0].tokens)})")
    return {"tokens": [r.tokens for r in results], "ms": (ms1, ms4),
            "launches": got, "stats": st}


# ---------------------------------------------------------------------------
# phases 10-11: the recurrent families (mamba2-780m, recurrentgemma-2b)
# ---------------------------------------------------------------------------

# arch -> the store the cold start reads (None: f32, cast to bf16 at A;
# "int8": dequantized to bf16 at A)
RECURRENT = {"mamba2-780m": None, "recurrentgemma-2b": "int8"}
# the layers phases 10-11 run of each (48 and 26 at full depth until PR
# 33; phase 28 trains both at full depth): a cut that pays for phase 32
RECURRENT_LAYERS = {"mamba2-780m": 6, "recurrentgemma-2b": 5}


def kernel_counts(cfg, *, quant: bool = False, paged: bool = False) -> tuple:
    """Launches of an LM's kernels per forward or prefill, and per decode
    step, from the layer kinds.  A paged step runs
    ``decode_attention_paged`` where a slotted one runs
    ``decode_attention``, but for sliding-window layers, whose rings stay
    slot-resident (h2o-danube-3-4b and mixtral-8x7b: every layer).
    Int8-resident params (``quant``) add a ``quant_matmul`` for every
    weight product, 6 an rglru layer (wx, wgate, wy and the GeGLU MLP's
    wg, wu, wd), 7 an attention layer (wq, wk, wv, wo and the MLP), an MoE
    layer 4 and 3 an expert (:func:`quant_products`: the router is
    dequantized) and 3 for a dense residual, and 1 for an untied head,
    and a ``weight_transform`` for every dequant at use: 2 an ssd layer
    (in_proj, out_proj) and 1 for a tied head.  The keys a path must not
    launch are kept at 0."""
    kinds = cfg.layer_kinds()
    n = {k: kinds.count(k) for k in ("ssd", "rglru", "attn", "moe")}
    attn = n["attn"] + n["moe"]        # layers with one attention each
    ring = attn if cfg.sliding_window else 0
    norms = 2 * len(kinds) + 1         # two a layer, and the final norm
    per_forward = {"ssd_scan": n["ssd"], "rglru_scan": n["rglru"],
                   "flash_attention": attn, "rmsnorm": norms}
    per_step = {"decode_attention": attn, "rmsnorm": norms}
    keep = set()
    if paged:
        per_step["decode_attention_paged"] = attn - ring
        per_step["decode_attention"] = ring
        keep |= {"decode_attention", "decode_attention_paged"}
    if quant:
        moe_layer = 4 + 3 * cfg.n_experts + 3 * int(cfg.dense_residual)
        products = {"quant_matmul": 6 * n["rglru"] + 7 * n["attn"]
                    + moe_layer * n["moe"] + int(not cfg.tie_embeddings),
                    "weight_transform": 2 * n["ssd"] + int(
                        cfg.tie_embeddings)}
        per_forward.update(products)
        per_step.update(products)
        keep |= set(products)
    return tuple({k: v for k, v in d.items() if v or k in keep}
                 for d in (per_forward, per_step))


def need_counts(got: dict, want: dict, what: str):
    for k, v in want.items():
        need(got[k] == v, f"{what}: {k} launched {got[k]} times, not {v}")


def delta(before: dict) -> dict:
    from repro_torch.kernels import ops
    after = ops.registry.dispatch_snapshot()
    return {k: after[k] - before[k] for k in after}


def recurrent_family(dev, workdir: str, arch: str) -> dict:
    """Full-width cicada cold start of ``arch`` at RECURRENT_LAYERS of its
    layers (first token inside the final E), warm forward against the
    in-pipeline logits, greedy generation, then four concurrent requests
    through the slotted
    scheduler and the rows probe; then the same four through the paged
    scheduler (16-token pages), and the int8-resident load and its
    schedulers (:func:`recurrent_int8`).  Returns each path's launch
    counts (zeroed at the start of the path, read at its end; the token
    checks against ``reference_generate`` run after) and the kernels it
    must have launched."""
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import GenerateSpec, reference_generate
    from repro_torch.serving.decode import sample_first
    from repro_torch.store.store import (BandwidthModel, WeightStore,
                                         deploy_model)

    cfg = dataclasses.replace(get_config(arch),
                              n_layers=RECURRENT_LAYERS[arch])
    quant = RECURRENT[arch]
    int8_name = arch if quant == "int8" else f"{arch}-int8"
    per_fwd, per_step = kernel_counts(cfg)
    model = transformer.build(cfg)
    t0 = time.perf_counter()
    store = WeightStore(os.path.join(workdir, arch),
                        BandwidthModel(bandwidth_mbps=2000))
    # each store from the same seed-0 draw on the card, a unit at a time
    deploy_model(store, model, arch, quant=quant,
                 params_by_unit=card_units(model))
    if int8_name != arch:          # the int8-resident load's store
        deploy_model(store, model, int8_name, quant="int8",
                     params_by_unit=card_units(model))
    plat = (f", {deploy_platform_store(workdir, arch, card_units(model))}"
            if arch in PLATFORM_STORES else "")
    print(f"  deployed {arch} ({cfg.param_count() / 1e6:.1f} M params, "
          f"layers {''.join(k[0] for k in cfg.layer_kinds())}) "
          f"{quant or 'f32'} {store.model_nbytes(arch) / 1e9:.3f} GB"
          + ("" if int8_name == arch else
             f" and int8 {store.model_nbytes(int8_name) / 1e9:.3f} GB") + plat
          + f" from seed 0 in {time.perf_counter() - t0:.1f} s (set-up); "
          f"kernels per forward {per_fwd}, per decode step {per_step}")

    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    spec = GenerateSpec(prompt=prompt[0], n_new=1)
    eng = ColdStartEngine(model, arch, store, strategy="cicada",
                          apply_dtype=torch.bfloat16)
    eng.warmup(batch)
    first = []
    ops.registry.reset_counts()
    res = eng.load(batch, on_logits=lambda lg: first.append(
        (sample_first(lg, spec, 128), time.monotonic())))
    in_load = ops.registry.dispatch_snapshot()
    tr = res.trace
    need(len(first) == 1, f"{arch}: on_logits did not fire once")
    e_final = tr.events_for("E")["final"]
    need(e_final.t_start <= first[0][1] <= e_final.t_end,
         f"{arch}: first token not sampled inside the final E")
    logits = res.logits
    need(tuple(logits.shape) == (1, 128, cfg.vocab_size) and
         bool(torch.isfinite(logits.float()).all()),
         f"{arch}: logits {tuple(logits.shape)} not finite/shaped")
    need_counts(in_load, per_fwd, f"{arch} cold start")
    before = ops.registry.dispatch_snapshot()
    warm, _ = model.forward(res.params, batch_dev(batch, dev))
    need_counts(delta(before), per_fwd, f"{arch} warm forward")
    diff = (warm.float() - logits.float()).abs().max().item()
    scale = logits.float().abs().max().item()
    summ = tr.summary()
    print(f"  load {tr.total_time() * 1e3:.1f} ms, utilization "
          f"{tr.utilization():.1%}, first token {first[0][0]} at "
          f"{(first[0][1] - tr.t0) * 1e3:.1f} ms, resident params "
          f"{param_bytes(res.params) / 1e6:.1f} MB, I/O floor "
          f"{store.model_nbytes(arch) / 2000e3:.0f} ms at 2000 MB/s; warm "
          f"forward vs in-pipeline logits max abs diff {diff:.3e} (max "
          f"|logit| {scale:.3f}); kernel launches in the load {in_load}")
    print("  stage work (s): " + ", ".join(
        f"{k[5:]} {summ[k]:.3f}" for k in ("work_L", "work_R", "work_A",
                                           "work_E"))
          + f"; waits (s): A {summ['wait_A']:.3f}, E {summ['wait_E']:.3f}")
    print(tr.render_gantt(100))
    need(diff <= BF16_ATOL * max(1.0, scale),
         f"{arch}: warm forward differs from in-pipeline logits")

    params = res.params
    before = ops.registry.dispatch_snapshot()
    t1 = time.perf_counter()
    toks = reference_generate(model, params, prompt[0], n_new=32)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t1) * 1e3
    want = {k: per_fwd.get(k, 0) + 31 * per_step.get(k, 0)
            for k in set(per_fwd) | set(per_step)}
    need_counts(delta(before), want, f"{arch} reference_generate")
    need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
         f"{arch}: bad tokens {toks}")
    print(f"  reference_generate, prompt 128: 32 greedy tokens in "
          f"{gen_ms:.1f} ms (host clock, prefill + 31 decode steps): "
          f"{toks}")

    prompts = [prompt[0][:n] for n in (37, 64, 100, 128)]
    slotted = run_scheduler(model, params, prompts, first[0], per_fwd,
                            per_step, f"{arch} slotted")
    path = ops.registry.dispatch_snapshot()
    if quant == "int8":
        transform_share(store, arch, torch.bfloat16, summ["work_A"],
                        in_load["weight_transform"])
    print(f"  kernel launches on the path: {path}")
    refs = [toks if len(p) == 128 else reference_generate(
        model, params, p, n_new=32) for p in prompts]
    check_tokens(f"{arch} slotted", prompts, slotted["tokens"], refs)
    rows_probe(model, params, prompts, arch)
    paths = {arch: (path, tuple(sorted(nonzero({**per_fwd, **per_step}))))}

    # the same four requests with 16-token pages: the attn layers' K/V in
    # the pools, the recurrent states slot-resident beside them
    page_bytes = 2 * cfg.n_kv_heads * 16 * cfg.dh * 2 * \
        cfg.layer_kinds().count("attn")
    print(f"  kv_page_bytes(16) = {model.kv_page_bytes(16)} B (bf16 K and V "
          f"of {cfg.layer_kinds().count('attn')} paged layers)")
    need(model.kv_page_bytes(16) == page_bytes,
         f"{arch}: kv_page_bytes(16) {model.kv_page_bytes(16)}, not "
         f"{page_bytes}")
    fwd_p, step_p = kernel_counts(cfg, paged=True)
    ops.registry.reset_counts()
    paged = run_scheduler(model, params, prompts, first[0], fwd_p, step_p,
                          f"{arch} paged", pages=16)
    paths[f"{arch} paged"] = (ops.registry.dispatch_snapshot(), tuple(
        sorted(nonzero({**fwd_p, **step_p}))))
    check_tokens(f"{arch} paged", prompts, paged["tokens"],
                 slotted["tokens"], "the slotted run's")
    paths.update(recurrent_int8(dev, model, store, int8_name, batch,
                                prompts, res,
                                res if quant == "int8" else None))
    return paths


def check_tokens(label: str, prompts, got, want,
                 what: str = "reference_generate", n: int = 32):
    """Each request's ``n`` tokens equal ``want``'s."""
    for p, g, w in zip(prompts, got, want):
        same = g == w
        print(f"  {label} prompt {len(p)}: "
              f"{'equal to' if same else 'DIFFERS from'} {what}: {g}")
        need(len(g) == n and same,
             f"{label} prompt {len(p)} differs from {what} at token "
             f"{first_diff(w, g)}")


def rows_probe(model, params, prompts, label: str) -> dict:
    """Every op of one decode step, its row at B = 4 against B = 1 (the
    probe that found rmsnorm's mean; kernels/ab.py): none may differ."""
    from repro_torch.kernels import ab
    t1 = time.perf_counter()
    probe = ab.probe_rows(model, params, [prompts[3], prompts[0], prompts[1],
                                          prompts[2]])
    print(f"  rows probe, {label}, one decode step at B=4 against B=1 "
          f"({(time.perf_counter() - t1):.1f} s): {probe['compared']} of "
          f"{probe['ops']} ops compared, first op that differs "
          f"{probe['first']}, sources {probe['sources']}, logits "
          f"{'bit-equal' if probe['logits_equal'] else 'DIFFER'}")
    need(probe["misaligned"] is None and not probe["sources"] and
         probe["logits_equal"],
         f"{label}: a decode step's row depends on the batch: {probe}")
    return probe


def recurrent_int8(dev, model, store, name: str, batch, prompts, bf16,
                   deq) -> dict:
    """The int8-resident (``compute_quant``) cicada cold start of ``name``
    (first token inside the final E; the warm forward equal to the
    in-pipeline logits; resident bytes beside the bf16-at-A load
    ``bf16``'s), ``reference_generate`` on its params, and the slotted and
    paged schedulers (tokens equal ``reference_generate``'s), with exact
    launches; then, outside the path, phase 6's rule against the f32
    oracle (the f32-compute forward over the same int8 weights) beside
    the dequant-at-A load ``deq`` (where None, the int8 store dequantized
    to f32 at A and cast at use, as phase 6 loads it), and the rows probe
    on the int8 params."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import reference_generate

    cfg = model.cfg
    arch = cfg.name
    if deq is None:
        deq = cicada_load(model, store, name, batch, f"{arch} int8 store "
                          f"dequantized at A (the oracle rule's floor)")["res"]
    fwd_q, step_q = kernel_counts(cfg, quant=True)
    fwd_qp, step_qp = kernel_counts(cfg, quant=True, paged=True)
    print(f"  int8-resident: kernels per forward {fwd_q}, per slotted step "
          f"{step_q}, per paged step {step_qp}")
    ops.registry.reset_counts()
    q = cicada_load(model, store, name, batch,
                    f"{arch} int8-resident (compute_quant)",
                    compute_quant=True)
    need_counts(q["load"], fwd_q, f"{arch} int8-resident load")
    need_counts(q["forward"], fwd_q, f"{arch} int8-resident warm forward")
    need(q["diff"] == 0.0, f"{arch} int8-resident: warm forward differs "
         f"from the in-pipeline logits by {q['diff']:.3e}")
    pq = q["res"].params
    qb, bb = param_bytes(pq), param_bytes(bf16.params)
    print(f"  resident params: int8-resident {qb / 1e6:.1f} MB, bf16 at A "
          f"{bb / 1e6:.1f} MB ({qb / bb:.3f}x)")
    before = ops.registry.dispatch_snapshot()
    t1 = time.perf_counter()
    refs = [reference_generate(model, pq, p, n_new=32) for p in prompts]
    torch.cuda.synchronize()
    print(f"  reference_generate on the int8-resident params, prompts "
          f"37/64/100/128: 4 x 32 greedy tokens in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms (host clock)")
    need_counts(delta(before), {k: 4 * (fwd_q.get(k, 0) + 31 * step_q.get(
        k, 0)) for k in set(fwd_q) | set(step_q)},
                f"{arch} int8-resident reference_generate")
    runs = {pages: run_scheduler(
        model, pq, prompts, q["first"], fwd_q if pages is None else fwd_qp,
        step_q if pages is None else step_qp,
        f"{arch} int8-resident {'slotted' if pages is None else 'paged'}",
        pages=pages) for pages in (None, 16)}
    path = ops.registry.dispatch_snapshot()
    kernels = tuple(sorted(nonzero({**fwd_q, **step_q, **step_qp})))
    for pages, run in runs.items():
        check_tokens(f"{arch} int8-resident "
                     f"{'slotted' if pages is None else 'paged'}", prompts,
                     run["tokens"], refs)
    f32_model = transformer.build(dataclasses.replace(
        cfg, compute_dtype=torch.float32))
    oracle, _ = f32_model.forward(pq, batch_dev(batch, dev))
    hold_to_oracle(f"{arch} int8-resident", q["res"].logits.float(),
                   deq.logits.float(), oracle.float(), q["first"][0])
    del oracle
    rows_probe(model, pq, prompts, f"{arch} int8-resident")
    return {f"{arch} int8-resident": (path, kernels)}


# ---------------------------------------------------------------------------
# phase 9: the card against the CPU, end to end
# ---------------------------------------------------------------------------

def card_vs_cpu(dev, workdir: str):
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving.decode import reference_generate
    from repro_torch.store.store import WeightStore, deploy_model

    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=4,
                              compute_dtype=torch.float32)
    cpu_model = transformer.build(cfg, device="cpu")
    gpu_model = transformer.build(cfg)
    store = WeightStore(os.path.join(workdir, "store4"))
    deploy_model(store, cpu_model, "smollm4", seed=1)
    deploy_model(store, cpu_model, "smollm4-int8", seed=1, quant="int8")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 64))
    batch = {"tokens": torch.as_tensor(prompt)}
    for label, name, quant in (("f32", "smollm4", False),
                               ("compute_quant int8", "smollm4-int8", True)):
        got = {}
        for side, m, d in (("card", gpu_model, None),
                           ("cpu", cpu_model, "cpu")):
            eng = ColdStartEngine(m, name, store, strategy="cicada",
                                  compute_quant=quant, device=d)
            res = eng.load(batch)
            toks = reference_generate(m, res.params, prompt[0], n_new=16,
                                      device=d)
            got[side] = (res.logits.float().cpu(), toks, res.params)
        a, b = got["card"][0], got["cpu"][0]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        print(f"  4-layer full-width f32, {label}: card vs CPU logits max "
              f"rel diff {rel:.3e} (tol 2e-3)")
        need(rel <= 2e-3, f"{label}: card and CPU logits differ by {rel}")
        ta, tb = got["card"][1], got["cpu"][1]
        print(f"  16 greedy tokens card {ta}\n                      cpu  "
              f"{tb}")
        need(margin_ok(cpu_model, got["cpu"][2], prompt[0], tb, ta, 2e-3,
                       f"{label} card vs CPU"),
             f"{label}: greedy tokens differ away from a near-tie")


def card_vs_cpu_arch(dev, workdir: str, arch: str, layers: int = 4):
    """``arch`` at ``layers`` layers of full width in f32 (recurrentgemma
    at 4: one pattern unit and a one-layer tail), cicada cold start and
    16 greedy tokens on the card and on the CPU, from one store of
    card-drawn weights (seed 1), removed after."""
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving.decode import reference_generate
    from repro_torch.store.store import WeightStore, deploy_model

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              compute_dtype=torch.float32)
    cpu_model = transformer.build(cfg, device="cpu")
    gpu_model = transformer.build(cfg)
    root = os.path.join(workdir, f"{arch}{layers}")
    store = WeightStore(root)
    deploy_model(store, cpu_model, "m", params_by_unit=card_units(gpu_model,
                                                                  seed=1))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 64))
    got = {}
    for side, m, d in (("card", gpu_model, None), ("cpu", cpu_model, "cpu")):
        res = ColdStartEngine(m, "m", store, strategy="cicada",
                              device=d).load({"tokens": torch.as_tensor(
                                  prompt)})
        toks = reference_generate(m, res.params, prompt[0], n_new=CPU_TOKENS,
                                  device=d)
        got[side] = (res.logits.float().cpu(), toks, res.params)
    shutil.rmtree(root)
    a, b = got["card"][0], got["cpu"][0]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"  {arch} {layers} layers "
          f"({''.join(k[0] for k in cfg.layer_kinds())}) full width f32 "
          f"({cfg.param_count() / 1e9:.3f} B params): card vs CPU logits "
          f"max rel diff {rel:.3e} (tol 2e-3)")
    need(rel <= 2e-3, f"{arch}: card and CPU logits differ by {rel}")
    ta, tb = got["card"][1], got["cpu"][1]
    print(f"  {CPU_TOKENS} greedy tokens card {ta}\n"
          f"                      cpu  {tb}")
    need(margin_ok(cpu_model, got["cpu"][2], prompt[0], tb, ta, 2e-3,
                   f"{arch} card vs CPU"),
         f"{arch}: greedy tokens differ away from a near-tie")


# ---------------------------------------------------------------------------
# phase 15: the serverless platform, full width
# ---------------------------------------------------------------------------

# the int8 stores the platform serves, as earlier phases deployed them:
# model name -> (directory under the work dir, store's model name)
PLATFORM_STORES = {"smollm-360m": ("platform-smollm", "smollm-int8"),
                   "recurrentgemma-2b": ("platform-recurrentgemma",
                                         "recurrentgemma-2b")}
# the platform phases (15, 19, 25) serve each model at full width and
# this many of its layers, the first of phases 4 and 11's weights
# (recurrentgemma-2b: one (rglru, rglru, attn) unit and a two-layer
# tail): their checks (cold flags, reads, launches, tokens, locks,
# peers) do not depend on depth
PLATFORM_LAYERS = {"smollm-360m": 4, "recurrentgemma-2b": 5}


def platform_config(arch: str):
    """The config the platform phases serve ``arch`` at."""
    from repro_torch.models.api import get_config
    return dataclasses.replace(get_config(arch),
                               n_layers=PLATFORM_LAYERS[arch])


def deploy_platform_store(workdir: str, arch: str, units) -> str:
    """The platform phases' int8 store of ``arch`` (:data:`PLATFORM_STORES`)
    from the first :data:`PLATFORM_LAYERS` layers of ``units`` (the full
    model's, a dict or ``(unit, tree)`` pairs in order) with its
    embedding and head; returns what it deployed, for the phase's set-up
    line."""
    from repro_torch.models import transformer
    from repro_torch.store.store import WeightStore, deploy_model
    where, name = PLATFORM_STORES[arch]
    shallow = transformer.build(platform_config(arch), device="cpu")
    keep = set(shallow.unit_names())
    pairs = units.items() if isinstance(units, dict) else units
    store = WeightStore(os.path.join(workdir, where))
    deploy_model(store, shallow, name, quant="int8",
                 params_by_unit=((n, t) for n, t in pairs if n in keep))
    return (f"its first {PLATFORM_LAYERS[arch]} layers int8 for the platform "
            f"phases {store.model_nbytes(name) / 1e9:.3f} GB")
PLATFORM_PROMPT, PLATFORM_NEW = 64, 16
PLATFORM_KEEP_ALIVE_S = 60.0
# memory_allocated after the final sweep may exceed its value before the
# platform by at most this much
PLATFORM_MEM_MARGIN = 64 << 20


def platform_store(workdir: str, stores: dict = PLATFORM_STORES,
                   sub: str = "platform"):
    """A store over the earlier phases' int8 deployments (``stores``:
    model name -> (directory under the work dir, store's model name)),
    named by architecture, that logs every unit read: (model, unit,
    bytes, time)."""
    from repro_torch.store.store import BandwidthModel, WeightStore

    class LoggingStore(WeightStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.reads = []

        def read_unit(self, model_name, unit, **kw):
            buf = super().read_unit(model_name, unit, **kw)
            self.reads.append((model_name, unit, buf.numel(),
                               time.monotonic()))
            return buf

    root = os.path.join(workdir, sub)
    os.makedirs(root, exist_ok=True)
    for arch, (where, name) in stores.items():
        link = os.path.join(root, arch)
        if not os.path.exists(link):
            os.symlink(os.path.join(workdir, where, name), link)
    return LoggingStore(root, BandwidthModel(bandwidth_mbps=2000))


def platform_specs():
    """make_spec for a replay: per model, two fixed prompts in turn, so a
    replay's requests map to the same prompts whatever its concurrency."""
    import numpy as np
    from repro_torch.models.api import get_config
    from repro_torch.serving import GenerateSpec
    prompts = {arch: [np.random.default_rng(10 + i).integers(
        0, get_config(arch).vocab_size, (PLATFORM_PROMPT,)) for i in (0, 1)]
        for arch in PLATFORM_STORES}
    turn = {arch: 0 for arch in PLATFORM_STORES}

    def make_spec(arch):
        i = turn[arch] % 2
        turn[arch] += 1
        return GenerateSpec(prompt=prompts[arch][i], n_new=PLATFORM_NEW,
                            seed=i)
    return make_spec, prompts


def expected_cold(trace, keep_alive: float) -> list:
    """Serial replay: a request is cold when its model has not run yet or
    sat idle past the TTL on the logical clock (first arrival = 0)."""
    last, out = {}, []
    for inv in trace:
        out.append(inv.model not in last or
                   inv.t - last[inv.model] > keep_alive)
        last[inv.model] = inv.t
    return out


def int8_leaves(store, name: str) -> int:
    """Leaves a load dequantizes (one weight_transform launch each)."""
    return sum(rec.get("quant") == "int8"
               for u in store.manifest(name)["units"].values()
               for rec in u["extents"])


def settled_memory() -> int:
    """memory_allocated with the card idle, cycles collected and cuBLAS's
    workspaces released: cuBLAS keeps one workspace per (thread, stream)
    pair it ran on, and every load brings new streams."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def print_responses(label: str, responses):
    import statistics
    for r in responses:
        tpot = statistics.median(r.tpot_s) * 1e3 if r.tpot_s else 0.0
        print(f"  {label} #{r.req_id:2d} {r.model:17s} "
              f"{'cold' if r.cold else 'warm'} load {r.load_s * 1e3:7.1f} "
              f"ms, ttft {r.ttft_s * 1e3:7.1f} ms, median tpot "
              f"{tpot:6.1f} ms, queue {r.queue_s * 1e3:7.1f} ms")


def serverless_platform(dev, workdir: str) -> dict:
    """Platform A serves smollm-360m and recurrentgemma-2b at full width
    and :data:`PLATFORM_LAYERS` layers from their int8 stores
    (dequantized at A) with a shared unbounded WeightCache: a
    serial replay of a 16-invocation trace whose TTL forces re-cold
    starts, then the same trace at concurrency 4.  Platform B serves
    smollm-360m int8-resident (``compute_quant``) with 16-token pages,
    against the same platform slotted.  Returns the path's launch counts
    (zeroed at the start, read before the checks against standalone
    loads)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import ServerlessPlatform, reference_generate
    from repro_torch.serving.trace import azure_like_trace, summarize

    archs = list(PLATFORM_STORES)
    store = platform_store(workdir)
    models = {a: transformer.build(platform_config(a)) for a in archs}
    units = {a: len(models[a].unit_names()) for a in archs}
    example = {a: {"tokens": torch.as_tensor(np.random.default_rng(3)
                                             .integers(0, models[a].cfg
                                                       .vocab_size,
                                                       (1, PLATFORM_PROMPT)))}
               for a in archs}
    builders = {a: (lambda a=a: (models[a], example[a])) for a in archs}
    trace = azure_like_trace(duration_s=600.0, n_invocations=16,
                             models=archs, seed=0)
    want_cold = expected_cold(trace, PLATFORM_KEEP_ALIVE_S)
    print(f"  trace {summarize(trace)}; keep-alive "
          f"{PLATFORM_KEEP_ALIVE_S:.0f} s: cold starts by model "
          f"{ {a: sum(c for c, i in zip(want_cold, trace) if i.model == a) for a in archs} }")
    for a in archs:
        need(sum(c for c, i in zip(want_cold, trace) if i.model == a) >= 2,
             f"{a}: the trace re-triggers no cold start")

    mem0 = settled_memory()
    ops.registry.reset_counts()
    plat = ServerlessPlatform(store, builders, strategy="cicada",
                              keep_alive_s=PLATFORM_KEEP_ALIVE_S,
                              cache_budget_bytes=0, gen_slots=4,
                              gen_cache_len=128, max_instances=1)

    # --- serial replay
    make_spec, prompts = platform_specs()
    t0 = time.perf_counter()
    serial = plat.run_trace(trace, None, concurrency=1, make_spec=make_spec)
    t_serial = time.perf_counter() - t0
    counts_serial = ops.registry.dispatch_snapshot()
    print_responses("serial", serial)
    cs = plat.cache_stats()
    ps = plat.pool_stats()
    loads = {a: ps[a].cold_starts for a in archs}
    print(f"  serial replay {t_serial:.1f} s; pools "
          f"{ {a: (p.cold_starts, p.warm_hits, p.evictions) for a, p in ps.items()} } "
          f"(cold, warm, evictions); cache hits {cs.hits}, misses "
          f"{cs.misses}, hit share {cs.hit_rate:.1%}, "
          f"{cs.bytes_cached / 1e9:.3f} GB resident (host)")
    need([r.cold for r in serial] == want_cold,
         f"cold flags {[r.cold for r in serial]} != TTL's {want_cold}")
    need(all(r.n_generated == PLATFORM_NEW for r in serial),
         "a serial response is short")
    for a in archs:
        cold = [r for r in serial if r.model == a and r.cold]
        print(f"  {a}: first cold start load {cold[0].load_s * 1e3:.1f} ms, "
              f"re-cold-starts from the cache "
              f"{[round(r.load_s * 1e3, 1) for r in cold[1:]]} ms")
        reads = [x for x in store.reads if x[0] == a]
        need(len(reads) == units[a] and
             sum(x[2] for x in reads) == store.model_nbytes(a),
             f"{a}: {len(reads)} unit reads, not one per unit")
        need(all(cold[0].t_arrival <= x[3] <= cold[0].t_done
                 for x in reads),
             f"{a}: a re-triggered cold start read the store")
        last = plat.pools[a]._instances[0].last_load.trace
        r_ev = last.events_for("R")
        need(len(r_ev) == units[a] and
             all(e.meta and e.meta.get("cached") for e in r_ev.values()),
             f"{a}: the last re-cold-start's R events are not all cached")
    need(cs.misses == sum(units.values()) and cs.hits == sum(
        (loads[a] - 1) * units[a] for a in archs) and cs.pinned == 0,
        f"cache stats {cs}")
    want = {k: 0 for k in counts_serial}
    for a in archs:
        per_fwd, per_step = kernel_counts(models[a].cfg)
        n_req = sum(1 for i in trace if i.model == a)
        # warmup forward at provisioning, the in-pipeline forward of each
        # load, and each request's prefill; then 15 steps a request
        for k, v in per_fwd.items():
            want[k] += (1 + loads[a] + n_req) * v
        for k, v in per_step.items():
            want[k] += n_req * (PLATFORM_NEW - 1) * v
        want["weight_transform"] += loads[a] * int8_leaves(store, a)
    print(f"  serial replay launches {counts_serial}")
    need(counts_serial == want,
         f"serial replay launches {counts_serial}, not {want}")

    # --- concurrent replay of the same trace, every instance cold
    plat.sweep(1e9)
    make_spec, _ = platform_specs()
    t0 = time.perf_counter()
    conc = plat.run_trace(trace, None, concurrency=4, make_spec=make_spec)
    t_conc = time.perf_counter() - t0
    print_responses("conc. ", conc)
    peak = {a: plat.metrics.gauge(f"pool/{a}/gen_active").max
            for a in archs}
    rs = plat.last_router_stats
    print(f"  concurrent replay {t_conc:.1f} s; generation holds at once "
          f"(peak) {peak}; router {rs}")
    need(max(peak.values()) > 1, "no generation request joined a live "
         "instance under concurrency")
    for r1, r4 in zip(serial, conc):
        need(r1.req_id == r4.req_id and list(r1.tokens) == list(r4.tokens),
             f"request {r1.req_id}: tokens at concurrency 4 differ from the "
             f"serial replay's at {first_diff(list(r1.tokens), list(r4.tokens))}")

    # --- memory after a sweep that evicts everything
    plat.sweep(1e10)
    need(all(p.live == 0 and p.busy == 0 for p in plat.pool_stats().values()),
         f"pools not all evicted {plat.pool_stats()}")
    del plat
    gc.collect()
    torch.cuda.synchronize()
    with_ws = torch.cuda.memory_allocated()
    mem1 = settled_memory()
    print(f"  memory_allocated before the platform {mem0 / 1e6:.1f} MB, "
          f"after the final sweep {mem1 / 1e6:.1f} MB (margin "
          f"{PLATFORM_MEM_MARGIN / 1e6:.1f} MB); cuBLAS workspaces of the "
          f"loads' and workers' (thread, stream) pairs "
          f"{(with_ws - mem1) / 1e6:.1f} MB, cleared before both readings")
    if mem1 > mem0 + PLATFORM_MEM_MARGIN:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape),
                        o.dtype) for o in gc.get_objects()
                       if torch.is_tensor(o) and o.is_cuda),
                      key=lambda x: -x[0])
        print(f"  live CUDA tensors, largest first: {live[:20]}")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"{(mem1 - mem0) / 1e6:.1f} MB stay allocated after eviction")
    torch.cuda.empty_cache()

    # --- platform B: int8-resident smollm-360m, paged, against slotted
    a = archs[0]
    sm_trace = [i for i in trace if i.model == a][:4]
    got = {}
    for label, pt in (("slotted", None), ("paged", 16)):
        make_spec, _ = platform_specs()
        before = ops.registry.dispatch_snapshot()
        pb = ServerlessPlatform(store, {a: builders[a]}, strategy="cicada",
                                keep_alive_s=PLATFORM_KEEP_ALIVE_S,
                                cache_budget_bytes=0, gen_slots=4,
                                gen_cache_len=128, compute_quant=True,
                                kv_page_tokens=pt)
        got[label] = pb.run_trace(sm_trace, None, concurrency=4,
                                  make_spec=make_spec)
        d = delta(before)
        print_responses(f"B {label:7s}", got[label])
        print(f"  platform B {label}: launches {d}")
        need(d["quant_matmul"] > 0, f"B {label}: no quant_matmul launch")
        if pt is not None:
            need(d["decode_attention_paged"] > 0 and
                 d["decode_attention"] == 0,
                 f"B paged: decode launches {d}")
        pb.sweep(1e10)
        del pb
    for r1, r2 in zip(got["slotted"], got["paged"]):
        need(list(r1.tokens) == list(r2.tokens),
             f"B: request {r1.req_id}'s paged tokens differ from slotted")
    path = ops.registry.dispatch_snapshot()
    gc.collect()
    torch.cuda.empty_cache()

    # --- tokens against reference_generate on a standalone load
    for a in archs:
        res = ColdStartEngine(models[a], a, store, strategy="cicada").load(
            example[a])
        ref = [reference_generate(models[a], res.params, p,
                                  n_new=PLATFORM_NEW, seed=i)
               for i, p in enumerate(prompts[a])]
        # the k-th request of a model got prompt k % 2 (platform_specs)
        for k, r in enumerate(r for r in serial if r.model == a):
            i = k % 2
            need(list(r.tokens) == ref[i],
                 f"{a} request {r.req_id} differs from reference_generate "
                 f"at token {first_diff(ref[i], list(r.tokens))}")
        print(f"  {a}: every response's tokens equal reference_generate's "
              f"on a standalone load: {ref}")
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": path,
            "kernels": ("weight_transform", "flash_attention",
                        "decode_attention", "rmsnorm", "rglru_scan",
                        "quant_matmul", "decode_attention_paged")}


# ---------------------------------------------------------------------------
# phases 16-18: the paper's own trio (ResNet-50, VGG-16, ViT-B/16)
# ---------------------------------------------------------------------------

TRIO = ("resnet50", "vgg16", "vit_b_16")
STRATEGIES = ("traditional", "pisel", "mini", "preload", "cicada")
# leaves of >= 2 dims, each one weight_transform launch per int8 load
TRIO_INT8_LEAVES = {"resnet50": 54, "vgg16": 16, "vit_b_16": 75}
# of max |logit|: strategies against each other, warm forward against the
# in-pipeline logits, platform responses against a standalone load
VISION_TOL = 1e-5
# the phase-16 deployments the platform serves, by architecture
VISION_STORES = {a: ("vision", a + "-int8") for a in TRIO}


def vision_cold_starts(dev, workdir: str) -> dict:
    """Deploy each of the trio (random weights, seed 0) to an f32 and an
    int8 store at 2000 MB/s; load it under the five strategies from the
    f32 store and with cicada from the int8 store, one (1, 3, 224, 224)
    image a load.  Returns the card's logits of each load."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import example_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.store.store import (BandwidthModel, WeightStore,
                                         deploy_model)

    store = WeightStore(os.path.join(workdir, "vision"),
                        BandwidthModel(bandwidth_mbps=2000))
    print(f"  TF32: cuDNN {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} (off for every timing "
          f"and comparison)")
    out = {}
    for arch in TRIO:
        cfg = get_config(arch)
        model = transformer.build(cfg)
        cpu_model = transformer.build(cfg, device="cpu")
        t0 = time.perf_counter()
        units = {}
        for i, name in enumerate(cpu_model.unit_names()):
            gen = torch.Generator().manual_seed(transformer.unit_seed(0, i))
            units[name] = cpu_model.init_unit(name, gen)
        n_params = sum(t.numel() for t in tree_util.leaves(units))
        deploy_model(store, cpu_model, arch, params_by_unit=units)
        deploy_model(store, cpu_model, arch + "-int8", quant="int8",
                     params_by_unit=units)
        del units
        n_int8 = int8_leaves(store, arch + "-int8")
        print(f"\n  deployed {arch} ({n_params / 1e6:.1f} M params, units "
              f"{len(model.unit_names())}) f32 "
              f"{store.model_nbytes(arch) / 1e6:.1f} MB, int8 "
              f"{store.model_nbytes(arch + '-int8') / 1e6:.1f} MB "
              f"({n_int8} int8 leaves) in {time.perf_counter() - t0:.1f} s "
              f"(set-up)")
        need(n_int8 == TRIO_INT8_LEAVES[arch],
             f"{arch}: {n_int8} int8 leaves, not {TRIO_INT8_LEAVES[arch]}")
        batch = example_batch(cfg)
        logits = {}
        for strat, name in ([(s, arch) for s in STRATEGIES]
                            + [("cicada", arch + "-int8")]):
            label = f"{strat} {'int8' if name.endswith('int8') else 'f32'}"
            eng = ColdStartEngine(model, name, store, strategy=strat)
            eng.warmup(batch)
            before = ops.registry.dispatch_snapshot()
            res = eng.load(batch)
            launched = delta(before)
            tr, lg = res.trace, res.logits
            need(tuple(lg.shape) == (1, cfg.vocab_size) and
                 bool(torch.isfinite(lg).all()),
                 f"{arch} {label}: logits {tuple(lg.shape)} not "
                 f"finite/shaped")
            warm, _ = model.forward(res.params, batch_dev(batch, dev))
            scale = lg.abs().max().item()
            diff = (warm - lg).abs().max().item()
            summ = tr.summary()
            floor = store.model_nbytes(name) / 2000e6
            want_wt = n_int8 if name.endswith("int8") else 0
            print(f"  {arch} {label}: load {tr.total_time() * 1e3:.1f} ms "
                  f"(I/O floor {floor * 1e3:.1f} ms), utilization "
                  f"{tr.utilization():.1%}, work (s) " + ", ".join(
                      f"{k[5:]} {summ[k]:.4f}" for k in (
                          "work_L", "work_R", "work_A", "work_E"))
                  + f", MiniLoader memory overhead "
                  f"{summ['mem_overhead_bytes'] / 1e6:.2f} MB, warm "
                  f"forward vs in-pipeline {diff:.3e} (max |logit| "
                  f"{scale:.3f}), weight_transform launches "
                  f"{launched['weight_transform']} (want {want_wt})")
            need(diff <= VISION_TOL * scale,
                 f"{arch} {label}: warm forward differs from the "
                 f"in-pipeline logits by {diff}")
            need(launched["weight_transform"] == want_wt and
                 sum(launched.values()) == want_wt,
                 f"{arch} {label}: launches {launched}")
            logits[label] = lg.float().cpu()
            del res, warm
        ref = logits["cicada f32"]
        scale = ref.abs().max().item()
        spread = max((lg - ref).abs().max().item()
                     for k, lg in logits.items() if k.endswith("f32"))
        d8 = (logits["cicada int8"] - ref).abs().max().item()
        print(f"  {arch}: five f32 strategies' logits within {spread:.3e} "
              f"of cicada's (tol {VISION_TOL} x {scale:.3f}); int8 store "
              f"vs f32 {d8:.3e}")
        need(spread <= VISION_TOL * scale,
             f"{arch}: the f32 strategies disagree by {spread}")
        out[arch] = logits
        torch.cuda.empty_cache()
    return out


def time_vgg_fc1(dev):
    """weight_transform at the largest leaf of this path, vgg16's fc1
    int8 (25088, 4096) -> f32 (a timing outside every path's count)."""
    import torch
    from repro_torch.kernels import weight_transform as wmod
    g = torch.Generator(device=dev).manual_seed(5)
    n, m = 25088, 4096
    w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(m, generator=g, device=dev) * 0.05
    got = wmod.weight_transform(w, s, out_dtype=torch.float32)
    need(torch.equal(got, wmod.plain(w, s, out_dtype=torch.float32)),
         "weight_transform (25088, 4096) differs from its plain version")
    del got
    bnd = cost_bound("weight_transform", w, s, out_dtype=torch.float32,
                     peak=torch.float32)
    extra_line("weight_transform", "vgg16 fc1 int8 (25088,4096) -> f32",
               lambda: wmod.weight_transform(w, s, out_dtype=torch.float32),
               lambda: wmod.plain(w, s, out_dtype=torch.float32),
               lambda: (w.float() * s).to(torch.float32), bnd,
               "(w.float() * s).to(dt)")
    del w
    torch.cuda.empty_cache()


def vision_card_vs_cpu(workdir: str, card: dict):
    """Each of the trio loaded on the CPU (cicada, f32 store) against the
    card's cicada f32 load of phase 16: logits within 2e-3 of max |logit|,
    top-1 equal."""
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.launch.serve import example_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.store.store import WeightStore

    store = WeightStore(os.path.join(workdir, "vision"))
    for arch in TRIO:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        res = ColdStartEngine(transformer.build(cfg, device="cpu"), arch,
                              store, strategy="cicada", device="cpu").load(
            example_batch(cfg))
        b, a = res.logits.float(), card[arch]["cicada f32"]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        top = (int(a.argmax()), int(b.argmax()))
        print(f"  {arch} full width f32: card vs CPU logits max rel diff "
              f"{rel:.3e} (tol 2e-3), top-1 card {top[0]}, CPU {top[1]} "
              f"(CPU load {time.perf_counter() - t0:.1f} s)")
        need(rel <= 2e-3, f"{arch}: card and CPU logits differ by {rel}")
        need(top[0] == top[1], f"{arch}: card and CPU top-1 differ {top}")


def vision_platform(dev, workdir: str) -> dict:
    """The trio served one-shot from phase 16's int8 stores (dequantized
    at A), strategy cicada, one shared unbounded WeightCache, one
    instance a model, keep-alive 60 s: a 16-invocation Azure-like trace
    replayed serially.  Returns the path's launch counts (zeroed at the
    start, read before the checks against standalone loads)."""
    import gc
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import example_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import ServerlessPlatform
    from repro_torch.serving import pool as pool_mod
    from repro_torch.serving.trace import azure_like_trace, summarize

    archs = list(TRIO)
    store = platform_store(workdir, VISION_STORES, "platform-vision")
    models = {a: transformer.build(get_config(a)) for a in archs}
    units = {a: len(models[a].unit_names()) for a in archs}
    example = {a: example_batch(models[a].cfg) for a in archs}
    trace = azure_like_trace(duration_s=600.0, n_invocations=16,
                             models=archs, seed=0)
    want_cold = expected_cold(trace, PLATFORM_KEEP_ALIVE_S)
    n_cold = {a: sum(c for c, i in zip(want_cold, trace) if i.model == a)
              for a in archs}
    print(f"  trace {summarize(trace)}; keep-alive "
          f"{PLATFORM_KEEP_ALIVE_S:.0f} s: cold starts by model {n_cold}")
    for a in archs:
        need(n_cold[a] >= 2, f"{a}: the trace re-triggers no cold start")

    # every response's logits, in serving order (one router worker)
    answers = []
    invoke = pool_mod.FunctionInstance.invoke

    def recording_invoke(self, batch):
        out, info = invoke(self, batch)
        answers.append((self.model_name, out.float().cpu()))
        return out, info

    mem0 = settled_memory()
    ops.registry.reset_counts()
    pool_mod.FunctionInstance.invoke = recording_invoke
    try:
        plat = ServerlessPlatform(
            store, {a: (lambda a=a: (models[a], example[a])) for a in archs},
            strategy="cicada", keep_alive_s=PLATFORM_KEEP_ALIVE_S,
            cache_budget_bytes=0, max_instances=1)
        t0 = time.perf_counter()
        serial = plat.run_trace(trace, lambda a: example[a], concurrency=1)
        t_serial = time.perf_counter() - t0
    finally:
        pool_mod.FunctionInstance.invoke = invoke
    counts = ops.registry.dispatch_snapshot()
    for r in serial:
        print(f"  #{r.req_id:2d} {r.model:9s} "
              f"{'cold' if r.cold else 'warm'} load {r.load_s * 1e3:7.1f} "
              f"ms, infer {r.infer_s * 1e3:6.1f} ms, utilization "
              f"{r.utilization:.1%}, latency {r.latency_s * 1e3:7.1f} ms")
    cs, ps = plat.cache_stats(), plat.pool_stats()
    loads = {a: ps[a].cold_starts for a in archs}
    pools = {a: (p.cold_starts, p.warm_hits, p.evictions)
             for a, p in ps.items()}
    print(f"  serial replay {t_serial:.1f} s; pools {pools} (cold, warm, "
          f"evictions); cache hits {cs.hits}, misses {cs.misses}, hit "
          f"share {cs.hit_rate:.1%}, {cs.bytes_cached / 1e6:.1f} MB "
          f"resident (host); launches {counts}")
    need([r.cold for r in serial] == want_cold,
         f"cold flags {[r.cold for r in serial]} != TTL's {want_cold}")
    need(len(answers) == len(serial) and
         [m for m, _ in answers] == [r.model for r in serial],
         "the recorded answers do not follow the responses")
    for a in archs:
        cold = [r for r in serial if r.model == a and r.cold]
        print(f"  {a}: first cold start load {cold[0].load_s * 1e3:.1f} ms, "
              f"re-cold-starts from the cache "
              f"{[round(r.load_s * 1e3, 1) for r in cold[1:]]} ms")
        reads = [x for x in store.reads if x[0] == a]
        need(len(reads) == units[a] and
             sum(x[2] for x in reads) == store.model_nbytes(a),
             f"{a}: {len(reads)} unit reads, not one per unit")
        need(all(cold[0].t_arrival <= x[3] <= cold[0].t_done
                 for x in reads),
             f"{a}: a re-triggered cold start read the store")
    need(cs.misses == sum(units.values()) and cs.hits == sum(
        (loads[a] - 1) * units[a] for a in archs) and cs.pinned == 0,
        f"cache stats {cs}")
    want = {k: 0 for k in counts}
    want["weight_transform"] = sum(loads[a] * int8_leaves(store, a)
                                   for a in archs)
    need(counts == want, f"serial replay launches {counts}, not {want}")

    plat.sweep(1e10)
    need(all(p.live == 0 and p.busy == 0 for p in plat.pool_stats().values()),
         f"pools not all evicted {plat.pool_stats()}")
    del plat, serial
    gc.collect()
    torch.cuda.synchronize()
    with_ws = torch.cuda.memory_allocated()
    mem1 = settled_memory()
    print(f"  memory_allocated before the platform {mem0 / 1e6:.1f} MB, "
          f"after the final sweep {mem1 / 1e6:.1f} MB (margin "
          f"{PLATFORM_MEM_MARGIN / 1e6:.1f} MB); cuBLAS workspaces "
          f"{(with_ws - mem1) / 1e6:.1f} MB, cleared before both readings")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"{(mem1 - mem0) / 1e6:.1f} MB stay allocated after eviction")
    torch.cuda.empty_cache()

    # --- every response against a standalone load on the same image
    for a in archs:
        ref = ColdStartEngine(models[a], a, store, strategy="cicada").load(
            example[a]).logits.float().cpu()
        scale = ref.abs().max().item()
        d = max((lg - ref).abs().max().item()
                for m, lg in answers if m == a)
        print(f"  {a}: {sum(m == a for m, _ in answers)} responses within "
              f"{d:.3e} of a standalone load's logits (tol {VISION_TOL} x "
              f"{scale:.3f})")
        need(d <= VISION_TOL * scale,
             f"{a}: a response differs from a standalone load by {d}")
    torch.cuda.empty_cache()
    return {"launches": counts}


# ---------------------------------------------------------------------------
# phase 19: the autoscaled platform under a 10x burst, with the lock probe
# ---------------------------------------------------------------------------

# the reference's SLO run (benchmarks/trace_bench.py, --workload slo): a
# trickle, then a 10x burst; 3 generation requests in 4, the rest one-shot
AUTOSCALE_PHASES = ((3.0, 1.5), (2.0, 15.0))
AUTOSCALE_GEN_SHARE = 0.75
AUTOSCALE_PROMPT, AUTOSCALE_NEW = 16, 8
AUTOSCALE_SLO_S = 0.075
AUTOSCALE_MAX_INSTANCES = 4
AUTOSCALE_KW = dict(rps_per_instance=0.4, window_s=4.0, horizon_s=2.0,
                    queue_per_instance=4, idle_scale_in_s=1e9,
                    interval_s=0.1, max_prewarm_workers=3)


def poisson_arrivals(phases, rng) -> list:
    """Arrival offsets (seconds from 0) of piecewise-constant-rate Poisson
    traffic, ``phases`` = ((duration_s, rate_rps), ...): the schedule of
    the reference's load generator (``benchmarks/load_gen.py``), draw for
    draw."""
    out, t0 = [], 0.0
    for dur, rate in phases:
        if rate > 0:
            t = t0 + float(rng.exponential(1.0 / rate))
            while t < t0 + dur:
                out.append(t)
                t += float(rng.exponential(1.0 / rate))
        t0 += dur
    return out


def autoscale_spec(i: int, vocab: int):
    """The generation request ``i`` sends (a fixed prompt per id)."""
    import numpy as np
    from repro_torch.serving import GenerateSpec
    rng = np.random.default_rng(max(i, 0) + 1)
    return GenerateSpec(prompt=rng.integers(0, vocab, (AUTOSCALE_PROMPT,)),
                        n_new=AUTOSCALE_NEW, seed=max(i, 0))


def open_loop(router, model: str, arrivals, picks, vocab: int, batch):
    """Submit one request per arrival at its scheduled wall time, never
    waiting for completions; returns ``[(req_id, gen, Response)]``.  A
    request that fails raises here, from its future."""
    from repro_torch.serving import Request
    t0 = time.monotonic()
    pending = []
    for i, (t_arr, gen) in enumerate(zip(arrivals, picks)):
        lag = t0 + t_arr - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        pending.append((i, gen, router.submit(Request(
            req_id=i, model=model, t_logical=t_arr,
            gen=autoscale_spec(i, vocab) if gen else None,
            batch=None if gen else batch))))
    return [(i, gen, fut.result()) for i, gen, fut in pending]


def slo_report(results) -> dict:
    """Client-side numbers of one run, all from submit: TTFT of the
    generation requests, latency of the one-shot ones, and the share of
    requests within ``AUTOSCALE_SLO_S``."""
    import numpy as np
    ttft = [r.queue_s + r.ttft_s for _, gen, r in results if gen]
    one = [r.queue_s + r.latency_s for _, gen, r in results if not gen]
    met = sum(t <= AUTOSCALE_SLO_S for t in ttft + one)
    return {"n": len(results), "n_gen": len(ttft), "n_oneshot": len(one),
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
            "oneshot_p99_ms": float(np.percentile(one, 99)) * 1e3,
            "attainment": met / len(results),
            "cold_served": sum(r.cold for _, _, r in results)}


def lock_hotspots(report: dict, n: int = 5):
    """The probe's ``n`` locks with the most contended wait and the ``n``
    with the longest total hold, as printable lines."""
    locks = report["locks"]
    lines = []
    for key, label in (("wait_s", "wait to acquire"), ("hold_s", "hold")):
        ranked = sorted(locks.items(), key=lambda kv: -kv[1][key])[:n]
        lines.append(f"  locks by {label}: " + "; ".join(
            f"{name} {st[key] * 1e3:.3f} ms (max {st[key.replace('_s', '_max_s')] * 1e3:.3f} ms, "
            f"{st['acquires']} acquires, {st['contended']} contended)"
            for name, st in ranked))
    return lines


def autoscaled_platform(dev, workdir: str) -> dict:
    """smollm-360m at full width and :data:`PLATFORM_LAYERS` layers from
    the platform's int8 store (dequantized at A), read at 2000 MB/s with
    no WeightCache, so every load reads the
    store: a pool of up to 4 instances with 2 generation slots each and
    no keep-alive eviction, fed the reference's SLO schedule (3 s at 1.5
    rps, then 2 s at 15 rps) open-loop through an 8-worker router, once
    without and once with the autoscaler, each from a cold pool, both
    under the lock probe.  Returns the path's launch counts (zeroed at the
    start, read before the checks against standalone loads)."""
    import gc
    import numpy as np
    import torch
    from repro_torch import analysis
    from repro_torch.analysis import lint, lockgraph
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import (Request, ServerlessPlatform,
                                     reference_generate)
    from repro_torch.serving import pool as pool_mod
    from repro_torch.serving import router as router_mod

    a = "smollm-360m"
    # only locks made while the switch is on are instrumented: set it
    # before the store (its BandwidthModel lock) and the platforms
    os.environ["REPRO_ANALYZE"] = "1"
    analysis.probe.reset()
    try:
        store = platform_store(workdir, {a: PLATFORM_STORES[a]},
                               "autoscale")
        model = transformer.build(platform_config(a))
        vocab = model.cfg.vocab_size
        n_units = len(model.unit_names())
        leaves = int8_leaves(store, a)
        batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
            0, vocab, (1, AUTOSCALE_PROMPT)))}
        arrivals = poisson_arrivals(AUTOSCALE_PHASES,
                                    np.random.default_rng(0))
        print(f"  {len(arrivals)} arrivals in "
              f"{sum(d for d, _ in AUTOSCALE_PHASES):.1f} s "
              f"({AUTOSCALE_PHASES} as (s, rps)); {n_units} units, "
              f"{leaves} int8 leaves, {store.model_nbytes(a) / 1e9:.3f} GB "
              f"a load")

        # every one-shot answer, from whichever worker served it; and the
        # requests a worker put back in the queue after its pool acquire
        # timed out (generation, one-shot)
        answers = []
        invoke = pool_mod.FunctionInstance.invoke
        requeue = router_mod.Router._requeue
        requeues = {True: 0, False: 0}

        def recording_invoke(self, b):
            out, info = invoke(self, b)
            answers.append(out.float().cpu())
            return out, info

        def counting_requeue(self, req, fut):
            requeues[req.gen is not None] += 1
            return requeue(self, req, fut)

        mem0 = settled_memory()
        ops.registry.reset_counts()
        pool_mod.FunctionInstance.invoke = recording_invoke
        router_mod.Router._requeue = counting_requeue
        runs = {}
        try:
            for tag, autoscale in (("noscale", None),
                                   ("autoscale", AUTOSCALE_KW)):
                rng = np.random.default_rng(0)      # same schedule twice
                arr = poisson_arrivals(AUTOSCALE_PHASES, rng)
                picks = rng.choice(2, size=len(arr), p=[
                    AUTOSCALE_GEN_SHARE, 1 - AUTOSCALE_GEN_SHARE]) == 0
                plat = ServerlessPlatform(
                    store, {a: lambda: (model, batch)}, strategy="cicada",
                    keep_alive_s=1e9, max_instances=AUTOSCALE_MAX_INSTANCES,
                    gen_slots=2, gen_cache_len=64, autoscale=autoscale)
                pool = plat.pools[a]
                router = plat.router(workers=2 * AUTOSCALE_MAX_INSTANCES)
                try:
                    # provision and warm an instance outside the run,
                    # then scale back in: both runs start cold
                    router.submit(Request(req_id=-1, model=a, gen=(
                        autoscale_spec(-1, vocab)))).result()
                    router.submit(Request(req_id=-2, model=a,
                                          batch=batch)).result()
                    for _ in range(200):
                        pool.scale_in(0)
                        if pool.stats().live == 0:
                            break
                        time.sleep(0.01)
                    need(pool.stats().live == 0,
                         f"{tag}: the pool did not scale in to 0")
                    del answers[:]
                    requeues.update({True: 0, False: 0})
                    base = pool.stats()
                    loads0 = plat.metrics.counter("coldstart/loads").value
                    reads0 = len(store.reads)
                    before = ops.registry.dispatch_snapshot()
                    if plat.autoscaler is not None:
                        plat.autoscaler.start()
                    t0 = time.perf_counter()
                    results = open_loop(router, a, arr, picks, vocab, batch)
                    seconds = time.perf_counter() - t0
                finally:
                    if plat.autoscaler is not None:
                        plat.autoscaler.stop()      # waits for prewarms
                    router.shutdown()
                d = delta(before)
                st = pool.stats()
                loads = int(plat.metrics.counter("coldstart/loads").value
                            - loads0)
                reads = len(store.reads) - reads0
                rep = slo_report(results)
                prewarms = st.prewarms - base.prewarms
                rs = router.stats
                snap = plat.metrics.snapshot()["counters"]
                print(f"  {tag}: {rep['n']} requests ({rep['n_gen']} "
                      f"generation, {rep['n_oneshot']} one-shot) in "
                      f"{seconds:.2f} s; TTFT p50 {rep['ttft_p50_ms']:.1f} "
                      f"ms, p99 {rep['ttft_p99_ms']:.1f} ms; one-shot p99 "
                      f"{rep['oneshot_p99_ms']:.1f} ms; within "
                      f"{AUTOSCALE_SLO_S * 1e3:.0f} ms {rep['attainment']:.1%}"
                      f"; cold-served {rep['cold_served']}, prewarms "
                      f"{prewarms}, loads {loads}, store reads {reads}, "
                      f"live at the end {st.live}; launches {d}")
                print(f"  {tag}: requeued after a saturated acquire: "
                      f"generation {requeues[True]}, one-shot "
                      f"{requeues[False]} (each one-shot time-out pauses "
                      f"generation joins {pool.EXCL_STARVATION_GRACE_S} s)"
                      f"; scale-ins "
                      f"{snap.get(f'autoscaler/{a}/scale_ins', 0):.0f}; "
                      f"per request (id, g/o, c if cold: queue + service "
                      f"to first token or answer, ms) " + " ".join(
                          f"{i}{'g' if gen else 'o'}{'c' if r.cold else ''}"
                          f":{r.queue_s * 1e3:.0f}+"
                          f"{(r.ttft_s if gen else r.latency_s) * 1e3:.0f}"
                          for i, gen, r in results))
                need(rs.rejected == 0 and rs.completed == rs.submitted and
                     not snap.get("router/errors") and len(results) ==
                     len(arr), f"{tag}: a request was rejected or failed "
                     f"({rs})")
                need(not snap.get(f"autoscaler/{a}/prewarm_errors"),
                     f"{tag}: a prewarm failed")
                need(prewarms == 0 if autoscale is None else prewarms >= 1,
                     f"{tag}: {prewarms} prewarms")
                cold = rep["cold_served"]
                need(st.cold_starts - base.cold_starts == cold and
                     st.warm_hits - base.warm_hits == len(results) - cold,
                     f"{tag}: pool counts {st} against {cold} cold-served "
                     f"of {len(results)} (a prewarm counted as served?)")
                need(loads == cold + prewarms,
                     f"{tag}: {loads} loads, not {cold} cold-served + "
                     f"{prewarms} prewarms")
                need(reads == n_units * loads,
                     f"{tag}: {reads} store reads, not {n_units} x {loads}")
                need(d["weight_transform"] == leaves * loads,
                     f"{tag}: {d['weight_transform']} weight_transform "
                     f"launches, not {leaves} x {loads}")
                need(all(r.n_generated == AUTOSCALE_NEW
                         for _, gen, r in results if gen),
                     f"{tag}: a generation response is short")
                runs[tag] = dict(rep, seconds=seconds, prewarms=prewarms,
                                 loads=loads, results=results,
                                 answers=list(answers))
                pool.scale_in(0)
                plat.sweep(1e10)
                need(all(p.live == 0 and p.busy == 0
                         for p in plat.pool_stats().values()),
                     f"{tag}: pools not all evicted {plat.pool_stats()}")
                del plat, pool, router
                gc.collect()
                torch.cuda.synchronize()
                with_ws = torch.cuda.memory_allocated()
                mem1 = settled_memory()
                print(f"  {tag}: memory_allocated before the phase "
                      f"{mem0 / 1e6:.1f} MB, after the sweep "
                      f"{mem1 / 1e6:.1f} MB (margin "
                      f"{PLATFORM_MEM_MARGIN / 1e6:.1f} MB); cuBLAS "
                      f"workspaces of the workers' and prewarm threads' "
                      f"(thread, stream) pairs {(with_ws - mem1) / 1e6:.1f}"
                      f" MB, cleared before both readings")
                need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
                     f"{tag}: {(mem1 - mem0) / 1e6:.1f} MB stay allocated "
                     f"after the sweep")
                torch.cuda.empty_cache()
        finally:
            pool_mod.FunctionInstance.invoke = invoke
            router_mod.Router._requeue = requeue
        path = ops.registry.dispatch_snapshot()

        # --- the lock probe over both runs
        observed = analysis.probe.report()
        for line in lock_hotspots(observed):
            print(line)
        cvw = observed["cv_waits"]
        print(f"  probe: {len(observed['locks'])} instrumented locks, "
              f"{len(observed['edges'])} observed order edges "
              f"{[(e['src'], e['dst']) for e in observed['edges']]}; "
              f"condition waits (waits, timed) "
              f"{ {k: (int(v['waits']), int(v['timed_waits'])) for k, v in cvw.items()} }")
        need(observed["cycles"] == [],
             f"observed lock-order cycles {observed['cycles']}")
        need(observed["hazards"] == [],
             f"locks held across I/O {observed['hazards']}")
        static, _ = lint.build_static_lockgraph(lint.load_models(
            os.path.join(HERE, "src", "repro_torch")))
        merged = lockgraph.merge(static, observed)
        print(f"  merged lock graph: {len(static)} static + "
              f"{len(observed['edges'])} observed edges, cycles "
              f"{merged['cycles']}")
        need(merged["cycles"] == [],
             f"static + observed lock graph cycles {merged['cycles']}")
    finally:
        os.environ.pop("REPRO_ANALYZE", None)

    # --- every response against a standalone load of the same store
    res = ColdStartEngine(model, a, store, strategy="cicada").load(batch)
    ref_logits = res.logits.float().cpu()
    scale = ref_logits.abs().max().item()
    ref_tokens = {}
    for tag, run in runs.items():
        d = max((lg - ref_logits).abs().max().item()
                for lg in run["answers"])
        need(len(run["answers"]) == run["n_oneshot"],
             f"{tag}: {len(run['answers'])} one-shot answers recorded, not "
             f"{run['n_oneshot']}")
        need(d <= VISION_TOL * scale,
             f"{tag}: a one-shot response differs from a standalone load "
             f"by {d}")
        for i, gen, r in run["results"]:
            if not gen:
                continue
            if i not in ref_tokens:
                spec = autoscale_spec(i, vocab)
                ref_tokens[i] = reference_generate(
                    model, res.params, spec.prompt, n_new=AUTOSCALE_NEW,
                    seed=spec.seed)
            need(list(r.tokens) == ref_tokens[i],
                 f"{tag}: request {i} differs from reference_generate at "
                 f"token {first_diff(ref_tokens[i], list(r.tokens))}")
        print(f"  {tag}: {run['n_oneshot']} one-shot responses within "
              f"{d:.3e} of a standalone load's logits (tol {VISION_TOL} x "
              f"{scale:.3f}); {run['n_gen']} generation responses' tokens "
              f"equal reference_generate's")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    no, au = runs["noscale"], runs["autoscale"]
    print(f"  TTFT p99 noscale {no['ttft_p99_ms']:.1f} ms, autoscale "
          f"{au['ttft_p99_ms']:.1f} ms; prewarms {no['prewarms']} and "
          f"{au['prewarms']}; loads {no['loads']} and {au['loads']}")
    return {"launches": path}


# ---------------------------------------------------------------------------
# phase 25: the multi-node cluster on one card
# ---------------------------------------------------------------------------

CLUSTER_ORIGIN_MBPS = 2000.0      # the origin store: one shared channel
CLUSTER_LINK_MBPS = 10000.0       # the intra-cluster link, a channel a node
CLUSTER_NODES = 4
CLUSTER_TRACE_SEED = 0            # three cold starts at a 60 s keep-alive


def cluster_platform(dev, workdir: str) -> dict:
    """smollm-360m at full width and :data:`PLATFORM_LAYERS` layers from
    the platform's int8 store (dequantized at A), served by simulated
    cluster nodes that all run on this card, with
    unbounded per-node WeightCaches, the origin at 2000 MB/s on one
    shared channel and the cluster link at 10000 MB/s a node, all under
    the lock probe: (a) node0 then node1 cold-start on pinned
    submissions, the second from its peer; (b) after ``flush()``, all four
    nodes cold-start at once, with peer exchange and without; (c) a
    16-invocation trace replayed serially through ``run_trace`` on two
    nodes; (d) the card's memory returns after ``flush()``.  Every
    response's logits equal a standalone load's and every token
    ``reference_generate``'s.  Returns the path's launch counts (zeroed at
    the start, read before the standalone load)."""
    import gc
    import numpy as np
    import torch
    from repro_torch import analysis
    from repro_torch.analysis import lint, lockgraph
    from repro_torch.cluster import ClusterPlatform
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.serving import Request, reference_generate
    from repro_torch.serving import pool as pool_mod
    from repro_torch.serving.trace import azure_like_trace, summarize

    a = "smollm-360m"
    answers = []
    invoke = pool_mod.FunctionInstance.invoke

    def recording_invoke(self, b):
        out, info = invoke(self, b)
        answers.append(out.float().cpu())
        return out, info

    def cluster(n, **kw):
        return ClusterPlatform(store, {a: lambda: (model, batch)},
                               n_nodes=n, cluster_bw_mbps=CLUSTER_LINK_MBPS,
                               cache_budget_bytes=0, **kw)

    def reads(cp):
        return [(nd.origin_reads(), nd.peer_reads()) for nd in cp.nodes]

    # only locks made while the switch is on are instrumented: set it
    # before the store (its BandwidthModel lock) and the clusters
    os.environ["REPRO_ANALYZE"] = "1"
    analysis.probe.reset()
    pool_mod.FunctionInstance.invoke = recording_invoke
    try:
        store = platform_store(workdir, {a: PLATFORM_STORES[a]}, "cluster")
        need((store.device.bandwidth_mbps, store.device.channels) ==
             (CLUSTER_ORIGIN_MBPS, 1), f"origin {store.device}")
        model = transformer.build(platform_config(a))
        keys = len(model.unit_names())
        leaves = int8_leaves(store, a)
        batch = {"tokens": torch.as_tensor(np.random.default_rng(3).integers(
            0, model.cfg.vocab_size, (1, PLATFORM_PROMPT)))}
        print(f"  {keys} units (placement keys), {leaves} int8 leaves, "
              f"{store.model_nbytes(a) / 1e9:.3f} GB a load; origin "
              f"{CLUSTER_ORIGIN_MBPS:.0f} MB/s on one shared channel, "
              f"link {CLUSTER_LINK_MBPS:.0f} MB/s a node; {card_line()}")
        mem0 = settled_memory()
        ops.registry.reset_counts()

        # --- (a) two pinned cold starts on a four-node cluster
        cp = cluster(CLUSTER_NODES, keep_alive_s=1e9)
        router = cp.router(workers_per_node=2)
        pinned, wt = [], []
        try:
            for i in range(2):
                before = ops.registry.dispatch_snapshot()
                t0 = time.perf_counter()
                pinned.append(router.submit_to(
                    f"node{i}", Request(req_id=i, model=a, batch=batch))
                    .result())
                wall = (time.perf_counter() - t0) * 1e3
                wt.append(delta(before)["weight_transform"])
                print(f"  (a) node{i}: cold {pinned[-1].cold}, load "
                      f"{pinned[-1].load_s * 1e3:.1f} ms, wall {wall:.1f} "
                      f"ms (host clock over the simulated pipes); "
                      f"(origin, peer) reads {reads(cp)[i]}")
        finally:
            router.shutdown()
        pl = cp.placement.snapshot()
        need(all(r.cold for r in pinned) and
             [r.node for r in pinned] == ["node0", "node1"],
             f"(a) responses {[(r.cold, r.node) for r in pinned]}")
        need(reads(cp)[:2] == [(keys, 0), (0, keys)],
             f"(a) (origin, peer) reads {reads(cp)}, not "
             f"[({keys}, 0), (0, {keys})]")
        need(pl["models"] == {a: {"keys": keys, "copies": 2 * keys}},
             f"(a) placement {pl}")
        need(wt == [leaves, leaves],
             f"(a) weight_transform launches {wt} per load, not {leaves}")
        r_ev = cp.node("node1").platform.pools[a]._instances[0] \
            .last_load.trace.events_for("R")
        need(len(r_ev) == keys and
             all(e.meta == {"peer": True} for e in r_ev.values()),
             "(a) node1's R events are not all peer transfers")
        answers_a = list(answers)
        need(len(answers_a) == 2, f"(a) {len(answers_a)} answers")

        # --- (b) one simultaneous cold burst on every node, after flush()
        bursts = {}
        for tag, peer in (("peer", True), ("origin-only", False)):
            if peer:
                cp.flush()
            else:
                cp = cluster(CLUSTER_NODES, keep_alive_s=1e9,
                             peer_exchange=False)
            need(cp.placement.snapshot()["models"] == {},
                 f"(b) {tag}: placement not empty before the burst")
            del answers[:]
            n_reads = len(store.reads)
            reads0 = reads(cp)
            before = ops.registry.dispatch_snapshot()
            router = cp.router(workers_per_node=2)
            try:
                t0 = time.perf_counter()
                futs = [router.submit_to(nd.node_id,
                                         Request(req_id=10 + i, model=a,
                                                 batch=batch))
                        for i, nd in enumerate(cp.nodes)]
                rs = [f.result() for f in futs]
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                router.shutdown()
            d = delta(before)
            rd = [(o - o0, p - p0)
                  for (o, p), (o0, p0) in zip(reads(cp), reads0)]
            origin = len(store.reads) - n_reads
            print(f"  (b) {tag}: {CLUSTER_NODES}-node cold burst wall "
                  f"{wall:.1f} ms (host clock over the simulated pipes); "
                  f"loads {[round(r.load_s * 1e3, 1) for r in rs]} ms; "
                  f"store reads {origin}; (origin, peer) reads by node "
                  f"{rd}; weight_transform {d['weight_transform']}; "
                  f"placement {cp.placement.snapshot()}")
            need(all(r.cold for r in rs), f"(b) {tag}: a warm response")
            want_origin = keys if peer else CLUSTER_NODES * keys
            need(origin == want_origin,
                 f"(b) {tag}: {origin} origin reads, not {want_origin}")
            if peer:
                need(sum(o for o, _ in rd) == keys and
                     sum(p for _, p in rd) == (CLUSTER_NODES - 1) * keys,
                     f"(b) peer: (origin, peer) reads {rd}")
            need(d["weight_transform"] == CLUSTER_NODES * leaves,
                 f"(b) {tag}: {d['weight_transform']} weight_transform "
                 f"launches, not {CLUSTER_NODES} x {leaves}")
            need(len(answers) == CLUSTER_NODES,
                 f"(b) {tag}: {len(answers)} answers")
            bursts[tag] = dict(wall_ms=wall, answers=list(answers))
            cp.flush()
            need(cp.placement.snapshot()["models"] == {},
                 f"(b) {tag}: placement not empty after flush()")
        del cp, router, futs, rs

        # --- (c) trace replay through the front end, two nodes
        trace = azure_like_trace(duration_s=600.0, n_invocations=16,
                                 models=[a], seed=CLUSTER_TRACE_SEED)
        want_cold = expected_cold(trace, PLATFORM_KEEP_ALIVE_S)
        need(sum(want_cold) >= 2, "(c) the trace re-triggers no cold start")
        cp = cluster(2, keep_alive_s=PLATFORM_KEEP_ALIVE_S, gen_slots=4,
                     gen_cache_len=128)
        make_spec, prompts = platform_specs()
        before = ops.registry.dispatch_snapshot()
        t0 = time.perf_counter()
        serial = cp.run_trace(trace, None, concurrency=1,
                              make_spec=make_spec)
        t_serial = time.perf_counter() - t0
        d = delta(before)
        print_responses("(c)", serial)
        ps = {nd.node_id: nd.platform.pool_stats()[a] for nd in cp.nodes}
        loads = sum(p.cold_starts for p in ps.values())
        instances = sum(p.size for p in ps.values())
        print(f"  (c) {summarize(trace)}: replay {t_serial:.1f} s; nodes "
              f"{[r.node for r in serial]}; pools (instances, cold, warm, "
              f"evictions) { {n: (p.size, p.cold_starts, p.warm_hits, p.evictions) for n, p in ps.items()} }; "
              f"(origin, peer) reads {reads(cp)}; launches {d}")
        need([r.cold for r in serial] == want_cold,
             f"(c) cold flags {[r.cold for r in serial]} != TTL's "
             f"{want_cold}")
        need(all(r.node in ("node0", "node1") for r in serial),
             f"(c) Response.node {[r.node for r in serial]}")
        need(all(r.n_generated == PLATFORM_NEW for r in serial),
             "(c) a response is short")
        need(sum(o for o, _ in reads(cp)) == keys,
             f"(c) origin reads {reads(cp)}, not {keys} in all")
        per_fwd, per_step = kernel_counts(model.cfg)
        want = {k: 0 for k in d}
        # the warmup forward of each provisioned instance, each load's
        # in-pipeline forward and each request's prefill; then the steps
        for k, v in per_fwd.items():
            want[k] += (instances + loads + len(trace)) * v
        for k, v in per_step.items():
            want[k] += len(trace) * (PLATFORM_NEW - 1) * v
        want["weight_transform"] += loads * leaves
        need(d == want, f"(c) launches {d}, not {want}")
        cp.flush()

        # --- (d) teardown
        need(cp.placement.snapshot()["models"] == {},
             "(d) placement not empty after flush()")
        need(all(p.live == 0 and p.busy == 0
                 for nd in cp.nodes for p in nd.platform.pool_stats()
                 .values()), "(d) an instance is still live")
        del cp
        gc.collect()
        torch.cuda.synchronize()
        mem1 = settled_memory()
        print(f"  (d) memory_allocated before the phase {mem0 / 1e6:.1f} "
              f"MB, after flush() {mem1 / 1e6:.1f} MB (margin "
              f"{PLATFORM_MEM_MARGIN / 1e6:.1f} MB)")
        need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
             f"(d) {(mem1 - mem0) / 1e6:.1f} MB stay allocated after "
             f"flush()")
        torch.cuda.empty_cache()
        path = ops.registry.dispatch_snapshot()

        # --- the lock probe over (a)-(c)
        observed = analysis.probe.report()
        for line in lock_hotspots(observed):
            print(line)
        print(f"  probe: {len(observed['locks'])} instrumented locks, "
              f"{len(observed['edges'])} observed order edges "
              f"{[(e['src'], e['dst']) for e in observed['edges']]}")
        need(observed["cycles"] == [],
             f"observed lock-order cycles {observed['cycles']}")
        need(observed["hazards"] == [],
             f"locks held across I/O {observed['hazards']}")
        static, _ = lint.build_static_lockgraph(lint.load_models(
            os.path.join(HERE, "src", "repro_torch")))
        merged = lockgraph.merge(static, observed)
        need(merged["cycles"] == [],
             f"static + observed lock graph cycles {merged['cycles']}")
    finally:
        pool_mod.FunctionInstance.invoke = invoke
        os.environ.pop("REPRO_ANALYZE", None)

    # --- every response against a standalone load of the same store
    res = ColdStartEngine(model, a, store, strategy="cicada").load(batch)
    ref = res.logits.float().cpu()
    for label, got in [("(a)", answers_a)] + [
            (f"(b) {t}", b["answers"]) for t, b in bursts.items()]:
        for lg in got:
            need(torch.equal(lg, ref),
                 f"{label}: a response differs from a standalone load by "
                 f"{(lg - ref).abs().max().item()}")
    ref_tokens = [reference_generate(model, res.params, p,
                                     n_new=PLATFORM_NEW, seed=i)
                  for i, p in enumerate(prompts[a])]
    for k, r in enumerate(serial):
        i = k % 2                   # the k-th request got prompt k % 2
        need(list(r.tokens) == ref_tokens[i],
             f"(c) request {r.req_id} differs from reference_generate at "
             f"token {first_diff(ref_tokens[i], list(r.tokens))}")
    print(f"  every response's logits bit-equal to a standalone load's "
          f"({len(answers_a)} pinned, "
          f"{sum(len(b['answers']) for b in bursts.values())} in bursts); "
          f"{len(serial)} replayed responses' tokens equal "
          f"reference_generate's; burst wall ms peer "
          f"{bursts['peer']['wall_ms']:.1f}, origin-only "
          f"{bursts['origin-only']['wall_ms']:.1f} (host clock over the "
          f"simulated pipes); {card_line()}")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": path}


# ---------------------------------------------------------------------------
# phase 26: shard-granular cold starts on a logical (1, 4) mesh
# ---------------------------------------------------------------------------

SHARD_MESH = (1, 4)
SHARD_MBPS = 2000.0       # each store channel, as phase 4's store


def counting_store(root: str, channels: int):
    """A store at SHARD_MBPS a channel that counts whole-unit reads and
    shard-stream opens."""
    import threading
    from repro_torch.store.store import BandwidthModel, WeightStore

    class CountingStore(WeightStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._count_lock = threading.Lock()
            self.reset()

        def read_unit(self, *a, **kw):
            with self._count_lock:
                self.unit_reads += 1
            return super().read_unit(*a, **kw)

        def open_unit(self, *a, **kw):
            with self._count_lock:
                self.shard_opens += 1
            return super().open_unit(*a, **kw)

        def reset(self):
            self.unit_reads = self.shard_opens = 0

    return CountingStore(root, BandwidthModel(bandwidth_mbps=SHARD_MBPS,
                                              channels=channels))


def same_params(a, b, what: str):
    import torch
    from repro_torch import tree as tree_util
    fa, fb = tree_util.leaves_with_path(a), tree_util.leaves_with_path(b)
    need([p for p, _ in fa] == [p for p, _ in fb], f"{what}: leaf paths")
    for (p, x), (_, y) in zip(fa, fb):
        need(x.dtype == y.dtype and torch.equal(x, y),
             f"{what}: param {'/'.join(p)} differs from the single-device "
             f"load's")


def by_shard(trace, stage: str) -> dict:
    """shard -> summed span (ms) of a stage's shard-tagged events."""
    out = {}
    for e in trace.events:
        if e.stage == stage and e.meta and "shard" in e.meta:
            out[e.meta["shard"]] = out.get(e.meta["shard"], 0.0) + \
                e.duration * 1e3
    return {k: round(v, 1) for k, v in sorted(out.items())}


def mesh_vs_single(model, name: str, one, four, mesh, batch, label: str,
                   **kw) -> dict:
    """A cicada cold start of ``name`` on one device from ``one`` (one
    channel) and on ``mesh`` from ``four`` (a channel a device): logits
    and params bit-equal, one shard stream a (unit, device), no whole
    read, R events from every shard, a T event for every (unit, shard)
    that transforms, and one ``weight_transform`` launch a transformed
    piece.  Returns the mesh load's launches."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    units = model.unit_names()
    ref_eng = ColdStartEngine(model, name, one, strategy="cicada", **kw)
    ref_eng.warmup(batch)
    ref = ref_eng.load(batch)
    eng = ColdStartEngine(model, name, four, strategy="cicada", mesh=mesh,
                          **kw)
    eng.warmup(batch)
    four.reset()
    before = ops.registry.dispatch_snapshot()
    res = eng.load(batch)
    d = delta(before)
    plans = [eng._plan(u) for u in units]
    n = mesh.size
    need(torch.equal(res.logits, ref.logits),
         f"{label}: mesh logits differ from the single-device load's")
    same_params(ref.params, res.params, label)
    need((four.shard_opens, four.unit_reads) == (len(units) * n, 0),
         f"{label}: {four.shard_opens} shard opens, {four.unit_reads} "
         f"whole reads, not {len(units) * n} and 0")
    R = [e for e in res.trace.events if e.stage == "R"]
    need(len(R) == len(units) * n and
         {e.meta["shard"] for e in R} == set(range(n)),
         f"{label}: R events {len(R)}, shards "
         f"{sorted({e.meta['shard'] for e in R})}")
    T = {(e.layer, e.meta["shard"]) for e in res.trace.events
         if e.stage == "T"}
    want_t = {(p.unit, s) for p in plans for s in range(n)
              if p.n_transformed(s)}
    need(T == want_t, f"{label}: T events on {len(T)} (unit, shard) "
         f"pairs, not {len(want_t)}")
    n_t = sum(p.n_transformed() for p in plans)
    need(d["weight_transform"] == n_t,
         f"{label}: {d['weight_transform']} weight_transform launches, "
         f"not the plan's {n_t} transformed pieces")
    specs = tree_util.leaves(res.shardings)
    sharded = sum(not s.is_fully_replicated for s in specs)
    need(sharded > 0, f"{label}: no leaf laid out sharded")
    nb = one.model_nbytes(name)
    per_ch = [sum(p.shard_nbytes(s) for p in plans) for s in range(n)]
    print(f"  {label}: load on one device {ref.trace.total_time() * 1e3:.1f}"
          f" ms (I/O floor {nb / (SHARD_MBPS * 1e3):.1f} ms on one "
          f"channel), on {SHARD_MESH} {res.trace.total_time() * 1e3:.1f} ms "
          f"(I/O floor {max(per_ch) / (SHARD_MBPS * 1e3):.1f} ms on "
          f"{n} channels: bytes a channel {per_ch}); utilization "
          f"{ref.trace.utilization():.1%} / {res.trace.utilization():.1%}; "
          f"{sharded} of {len(specs)} leaves sharded; "
          f"weight_transform {n_t} (pieces)")
    summ = res.trace.summary()
    print(f"    R ms by shard {by_shard(res.trace, 'R')}, T ms by shard "
          f"{by_shard(res.trace, 'T')}; mesh stage work (s): L "
          f"{summ['work_L']:.3f}, R {summ['work_R']:.3f}, T "
          f"{summ['work_T']:.3f}, A {summ['work_A']:.3f}, E "
          f"{summ['work_E']:.3f}; logits and params bit-equal")
    return d


def sample_threads(stop, period_s: float, out: dict):
    """Until ``stop`` is set, every ``period_s`` note where each other
    thread stands: its kind (the name without a pool's ``_N``) and its
    innermost frame in the port (file, function, line), else ``other``
    and its innermost function.
    ``out[(kind, where)]`` counts the samples."""
    import threading
    me = threading.get_ident()
    src = os.path.join(HERE, "src", "repro_torch")
    while not stop.wait(period_s):
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            kind = names.get(ident, "?").rsplit("_", 1)[0]
            where = f"other:{frame.f_code.co_name}"
            while frame is not None:
                code = frame.f_code
                if code.co_filename.startswith(src):
                    where = (f"{os.path.relpath(code.co_filename, src)}:"
                             f"{code.co_name}:{frame.f_lineno}")
                    break
                frame = frame.f_back
            out[(kind, where)] = out.get((kind, where), 0) + 1


def split_mesh_load(eng, batch, label: str):
    """One more load of ``eng`` (warmed up, on a mesh) traced two ways, to
    split where its wall time goes.  torch.profiler with host and device
    activity gives the device's busy time (the union of its kernels and
    copies, so the lanes' overlapping streams count once) and the CUDA
    runtime calls by thread.  A sampler that reads every thread's stack
    each millisecond gives each kind of thread's time by the line of the
    port it stands on (running or waiting).  The profiler's table goes
    to ``chiprun_out/phase26_profile.txt``."""
    import threading
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    samples: dict = {}
    stop = threading.Event()
    sampler = threading.Thread(target=sample_threads, name="sampler",
                               args=(stop, 1e-3, samples))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sampler.start()
        t0 = time.perf_counter()
        eng.load(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        stop.set()
        sampler.join()
    spans, runtime = [], {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
        elif ev.name.startswith("cuda"):
            runtime[ev.name] = runtime.get(ev.name, 0.0) + \
                ev.self_cpu_time_total
    busy = union_ms(spans)
    top = "; ".join(f"{k} {t / 1e3:.1f}" for k, t in sorted(
        runtime.items(), key=lambda kv: -kv[1])[:6])
    print(f"  profiled mesh load, {label}: wall {wall:.1f} ms; device busy "
          f"{busy:.1f} ms ({busy / wall:.1%} of wall, {len(spans)} kernels "
          f"and copies); CUDA runtime calls, ms over all threads: {top}")
    kinds: dict = {}
    for (kind, where), n in samples.items():
        kinds.setdefault(kind, []).append((n, where))
    for kind, rows in sorted(kinds.items(), key=lambda kv: -sum(
            n for n, _ in kv[1])):
        total = sum(n for n, _ in rows)
        lines = ", ".join(f"{w} {n / total:.0%}"
                          for n, w in sorted(rows, reverse=True)[:5])
        print(f"    thread {kind}: {total} samples; {lines}")
    need(busy > 0, f"{label}: the profiler saw no device time")
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "phase26_profile.txt"), "w") as f:
        f.write(f"{label}: wall {wall:.1f} ms, device busy {busy:.1f} ms\n")
        for (kind, where), n in sorted(samples.items(),
                                       key=lambda kv: -kv[1]):
            f.write(f"{kind}\t{where}\t{n}\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60))


def sharded_cold_starts(dev, workdir: str) -> dict:
    """Phase 26: smollm-360m at full width from phase 4's f32 and int8
    stores, cold-started on a logical (1, 4) mesh on this card with one
    store channel a device, under the lock probe: the f32 store at f32
    and with bf16 at A, the int8 store with bf16 at A, each against a
    single-device load on one channel (:func:`mesh_vs_single`); one more
    int8 mesh load under the profiler (:func:`split_mesh_load`); a second
    mesh cold start through a shared WeightCache with no store open; an
    ``InstancePool(mesh_shape=4)`` scale-out served from that cache;
    ``launch/serve.py --mesh 4`` on a 4-invocation one-shot trace; and
    phase 20's int8 mixtral-8x7b with bf16 at A on the mesh (its 8
    experts two to a device) against its single-device load.  Returns
    the launches of the mesh runs (their counts summed; the
    single-device loads they are held against are left out)."""
    import contextlib as ctx
    import gc
    import io
    import numpy as np
    import torch
    from repro_torch import analysis
    from repro_torch.analysis import lint, lockgraph
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import InstancePool
    from repro_torch.store.cache import WeightCache

    launches = {n: 0 for n in ops.registry.names()}

    def add(d):
        for k, v in d.items():
            launches[k] += v

    os.environ["REPRO_ANALYZE"] = "1"
    analysis.probe.reset()
    try:
        mesh = make_serving_mesh(SHARD_MESH)
        root = os.path.join(workdir, "store")
        one, four = counting_store(root, 1), counting_store(root, 4)
        cfg = get_config("smollm-360m")
        model = transformer.build(cfg)
        units = model.unit_names()
        batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (1, 128)))}
        print(f"  mesh {mesh}; {len(units)} units; {card_line()}")
        for label, name, adt in (
                ("f32 store, f32", "smollm", None),
                ("f32 store, bf16 at A", "smollm", torch.bfloat16),
                ("int8 store, bf16 at A", "smollm-int8", torch.bfloat16)):
            add(mesh_vs_single(model, name, one, four, mesh, batch,
                               f"smollm-360m {label}", apply_dtype=adt))
            gc.collect()

        # where a mesh load's wall time goes: one profiled int8 load
        eng = ColdStartEngine(model, "smollm-int8", four, mesh=mesh,
                              apply_dtype=torch.bfloat16)
        eng.warmup(batch)
        before = ops.registry.dispatch_snapshot()
        split_mesh_load(eng, batch, "smollm-360m int8 store, bf16 at A")
        add(delta(before))
        del eng
        gc.collect()

        # a second mesh cold start through a shared WeightCache
        cache = WeightCache(0)
        res = []
        four.reset()
        for i in range(2):
            eng = ColdStartEngine(model, "smollm-int8", four, mesh=mesh,
                                  cache=cache, apply_dtype=torch.bfloat16)
            eng.warmup(batch)
            before = ops.registry.dispatch_snapshot()
            res.append(eng.load(batch))
            add(delta(before))
            need(four.shard_opens == len(units) * SHARD_MESH[1],
                 f"cache load {i}: {four.shard_opens} shard opens, not "
                 f"{len(units) * SHARD_MESH[1]}")
        st = cache.stats()
        need(torch.equal(res[0].logits, res[1].logits),
             "the cache-served mesh load's logits differ")
        need(all(e.meta.get("cached") for e in res[1].trace.events
                 if e.stage == "R") and st.pinned == 0,
             f"cache-served load: R events not all cached or pins left "
             f"({st.pinned})")
        print(f"  second mesh cold start through a shared WeightCache: "
              f"{four.shard_opens} store opens in both loads, cache hits "
              f"{st.hits} misses {st.misses}; loads "
              f"{res[0].trace.total_time() * 1e3:.1f} / "
              f"{res[1].trace.total_time() * 1e3:.1f} ms; logits bit-equal")
        del res, eng

        # InstancePool(mesh_shape=4): a scale-out served from the cache
        pool = InstancePool("smollm-int8", lambda: (model, batch), four,
                            max_instances=2, cache=cache, mesh_shape=4)
        insts = [pool.acquire(), pool.acquire()]
        before = ops.registry.dispatch_snapshot()
        outs = [inst.invoke(batch) for inst in insts]
        add(delta(before))
        for inst in insts:
            pool.release(inst, logical_now=0.0, cold=True)
        need(all(info["cold"] for _, info in outs) and
             four.shard_opens == len(units) * SHARD_MESH[1],
             f"pool scale-out: cold {[i['cold'] for _, i in outs]}, "
             f"{four.shard_opens} store opens")
        need(torch.equal(outs[0][0], outs[1][0]),
             "pool scale-out: the instances answer differently")
        ref = ColdStartEngine(model, "smollm-int8", one).load(batch)
        need(torch.equal(outs[0][0], ref.logits),
             "pool scale-out: logits differ from a single-device load's")
        print(f"  InstancePool(mesh_shape=4): two cold instances served "
              f"from the cache (no store open), loads "
              f"{[round(i['load_s'] * 1e3, 1) for _, i in outs]} ms, "
              f"logits bit-equal to a single-device load's")
        del pool, insts, outs, ref
        cache.clear()
        gc.collect()

        # the launcher, --mesh 4, over phase 4's f32 store
        lroot = os.path.join(workdir, "shard-launch")
        os.makedirs(lroot, exist_ok=True)
        link = os.path.join(lroot, "smollm-360m")
        if not os.path.exists(link):
            os.symlink(os.path.join(root, "smollm"), link)
        buf = io.StringIO()
        before = ops.registry.dispatch_snapshot()
        with ctx.redirect_stdout(buf):
            got = tserve.main(["--models", "smollm-360m", "--full",
                               "--mesh", "4", "--invocations", "4",
                               "--duration", "60", "--keep-alive", "20",
                               "--workload", "oneshot", "--bandwidth-mbps",
                               f"{SHARD_MBPS:.0f}", "--store", lroot])
        add(delta(before))
        out = buf.getvalue()
        print("\n".join("    " + line for line in out.splitlines()))
        rs = got["cicada"]
        need("mesh: (1, 4) = 4 logical devices on one physical device" in
             out, "launcher: no mesh line")
        need(len(rs) == 4 and 1 <= sum(r.cold for r in rs),
             f"launcher: {len(rs)} responses, {sum(r.cold for r in rs)} "
             f"cold")
        del got, rs
        gc.collect()
        torch.cuda.empty_cache()

        # mixtral-8x7b at MIXTRAL_LAYERS, phase 20's int8 store, bf16 at A
        mcfg = dataclasses.replace(get_config("mixtral-8x7b"),
                                   n_layers=MIXTRAL_LAYERS)
        mmodel = transformer.build(mcfg)
        mroot = os.path.join(workdir, "mixtral-int8")
        mbatch = {"tokens": torch.as_tensor(np.random.default_rng(0)
                                            .integers(0, mcfg.vocab_size,
                                                      (1, 128)))}
        m1, m4 = counting_store(mroot, 1), counting_store(mroot, 4)
        add(mesh_vs_single(mmodel, "mixtral-int8", m1, m4, mesh, mbatch,
                           f"mixtral-8x7b at {MIXTRAL_LAYERS} layers, int8 "
                           f"store, bf16 at A", apply_dtype=torch.bfloat16))
        eng = ColdStartEngine(mmodel, "mixtral-int8", m4, mesh=mesh,
                              apply_dtype=torch.bfloat16)
        wg = [p for s in eng._plan("block_000").pieces for p in s
              if p.leaf == "moe/experts/wg"]
        per = mcfg.n_experts // SHARD_MESH[1]
        need(len(wg) == SHARD_MESH[1] and
             all(p.index[0].stop - p.index[0].start == per for p in wg),
             f"mixtral expert wg pieces {[p.index for p in wg]}, not "
             f"{per} experts a device")
        del mmodel, eng
        gc.collect()
        torch.cuda.empty_cache()

        # the lock probe over the phase
        observed = analysis.probe.report()
        for line in lock_hotspots(observed):
            print(line)
        need(observed["cycles"] == [],
             f"observed lock-order cycles {observed['cycles']}")
        need(observed["hazards"] == [],
             f"locks held across I/O {observed['hazards']}")
        static, _ = lint.build_static_lockgraph(lint.load_models(
            os.path.join(HERE, "src", "repro_torch")))
        merged = lockgraph.merge(static, observed)
        need(merged["cycles"] == [],
             f"static + observed lock graph cycles {merged['cycles']}")
        print(f"  probe: {len(observed['locks'])} instrumented locks, no "
              f"cycle, no lock held across a store read")
    finally:
        os.environ.pop("REPRO_ANALYZE", None)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phases 20-24: the MoE family (mixtral-8x7b, arctic-480b) and the audio
# (hubert-xlarge) and VLM (internvl2-76b) stub families
# ---------------------------------------------------------------------------

MIXTRAL_LAYERS = 2          # of mixtral-8x7b's 32, at full width
INTERNVL_LAYERS = 1         # of internvl2-76b's 80, at full width (cut
                            # from 2 to pay for phase 32)
HUBERT_FRAMES = 256         # one (1, 256, 512) frame batch
# a card/CPU difference in an expert choice is a near-tie when the
# routing weights it swaps differ by at most this much
ROUTE_TIE = 2e-3
# the greedy tokens each side generates in the card/CPU phases of the
# billion-parameter models (every CPU step reads all their f32 weights)
CPU_TOKENS = 16
# a unit-at-a-time deploy holds at most this many times the largest
# unit's f32 bytes (a dict of every unit's f32 would hold the model's)
DEPLOY_RSS_UNITS = 8


def card_units(model, seed: int = 0):
    """The model's units initialised on the card (one CUDA generator per
    unit, seeded as ``deploy_model`` seeds its CPU ones): random weights
    from a seed, made on the card because a CPU init of billions of
    normals would dominate the set-up.  ``(unit, tree)`` pairs in
    ``unit_names()`` order, each drawn only when the store's deploy
    reaches it; the store quantizes an int8 leaf on the card and moves
    the int8 values (an f32 leaf: its f32) to the host, so the host holds
    one unit at a time."""
    import torch
    from repro_torch.models import transformer
    for i, name in enumerate(model.unit_names()):
        gen = torch.Generator(device=model.device).manual_seed(
            transformer.unit_seed(seed, i))
        yield name, model.init_unit(name, gen)


def check_card_quantization(model, store, name: str, unit: str,
                            skip=()):
    """One unit of a store deployed from :func:`card_units` (seed 0),
    quantized on the card, against the host's quantization of the same
    draw (numpy's formula in torch's CPU ops): every int8 value and scale
    bit-equal, but for the leaves in ``skip``."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.store import store as store_mod
    gen = torch.Generator(device=model.device).manual_seed(
        transformer.unit_seed(0, model.unit_names().index(unit)))
    tree = model.init_unit(unit, gen)
    # the same files without the simulated device's 2000 MB/s
    stored = store_mod.WeightStore(store.root).read_and_deserialize(name,
                                                                    unit)
    n = 0
    for path, leaf in store_mod.flatten_unit(tree):
        if leaf.ndim < 2 or path in skip:
            continue
        q, s = store_mod.quantize_int8(leaf.cpu().numpy())
        got_q, got_s = stored.pop(path)
        need(np.array_equal(got_q.numpy(), q) and
             np.array_equal(got_s.numpy(), s),
             f"{name}/{unit}/{path}: the card's int8 differs from the host's")
        n += q.size
    print(f"  {unit}: the card's quantization at deploy bit-equal to the "
          f"host's ({n / 1e6:.1f} M values)")


def rss_bytes() -> int:
    """The process's resident memory now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise Failure("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def rss_peak(period_s: float = 0.005):
    """The peak of the process's resident memory while the block runs,
    above its value on entry (``out["bytes"]``), sampled from
    ``/proc/self/status`` on a thread every ``period_s``: ``ru_maxrss``
    is the peak of the whole run, so earlier phases would hide it."""
    import threading
    out = {"base": rss_bytes()}
    out["peak"] = out["base"]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            out["peak"] = max(out["peak"], rss_bytes())
            stop.wait(period_s)

    t = threading.Thread(target=sample, name="rss_sampler", daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        out["peak"] = max(out["peak"], rss_bytes())
        out["bytes"] = out["peak"] - out["base"]


def unit_f32_bytes(model) -> int:
    """The largest unit's bytes at f32, from its abstract tree."""
    from repro_torch import tree as tree_util
    return max(sum(4 * t.numel()
                   for t in tree_util.leaves(model.abstract_unit(n)))
               for n in model.unit_names())


# a deploy needs this many times its store's bytes free on the disk
DISK_MARGIN = 1.1
# phase 32's stores lie in host memory: the card's machine takes at most
# 45 GiB of writes to its disk in a run, and mixtral-8x7b's int8 store
# alone is 43.5 GiB; the host memory a store there leaves to the process
# (its pinned read buffers, a unit's int8 in a deploy)
SHM = "/dev/shm"
HOST_RESERVE = 12 << 30


def int8_store_bytes(model) -> int:
    """The bytes of ``model``'s int8 store, from its abstract units (at
    most 63 more a leaf than the store's: each leaf counted 64-byte
    aligned): a byte a value and an f32 scale a column of each 2-D+ float
    leaf, the other leaves at their dtype."""
    from repro_torch import tree as tree_util
    total = 0
    for n in model.unit_names():
        for t in tree_util.leaves(model.abstract_unit(n)):
            nb = (t.numel() + 4 * t.shape[-1]
                  if t.dim() >= 2 and t.dtype.is_floating_point
                  else t.numel() * t.element_size())
            total += nb + (-nb) % 64
    return total


def disk_free(path: str, when: str) -> int:
    """Prints and returns the bytes free on ``path``'s file system; for a
    directory in host memory (:data:`SHM`) the host memory available
    beyond :data:`HOST_RESERVE`, where that is less."""
    u = shutil.disk_usage(path)
    free, mem = u.free, ""
    if os.path.realpath(path).startswith(SHM + os.sep):
        avail = mem_available()
        free = min(free, avail - HOST_RESERVE)
        mem = (f" (in host memory: {avail / 1e9:.1f} GB available, "
               f"{HOST_RESERVE / 1e9:.0f} GB of it kept for the process)")
    print(f"  disk at {path} {when}: {u.free / 1e9:.1f} GB free of "
          f"{u.total / 1e9:.1f} GB{mem}")
    return free


def deploy_int8(model, workdir: str, name: str):
    """An int8 store of ``model`` at 2000 MB/s, deployed one unit at a
    time from card-drawn weights, once the disk holds
    :data:`DISK_MARGIN` x its bytes free; prints its sizes and the peak
    of the process's resident memory during the deploy, which
    :data:`DEPLOY_RSS_UNITS` bounds in units of the largest unit's f32
    bytes."""
    from repro_torch.store.store import (BandwidthModel, WeightStore,
                                         deploy_model)
    cfg = model.cfg
    want = int8_store_bytes(model)
    free = disk_free(workdir, f"before {name}'s deploy")
    need(free >= DISK_MARGIN * want,
         f"{name}: {free / 1e9:.1f} GB free at {workdir}, under "
         f"{DISK_MARGIN} x its store's {want / 1e9:.1f} GB")
    t0 = time.perf_counter()
    store = WeightStore(os.path.join(workdir, name),
                        BandwidthModel(bandwidth_mbps=2000))
    with rss_peak() as rss:
        deploy_model(store, model, name, quant="int8",
                     params_by_unit=card_units(model))
    nb = store.model_nbytes(name)
    unit = unit_f32_bytes(model)
    print(f"  deployed {cfg.name} at {cfg.n_layers} layers "
          f"({cfg.param_count() / 1e9:.3f} B params, "
          f"{cfg.active_param_count() / 1e9:.3f} B active a token), int8 "
          f"{nb / 1e9:.3f} GB (I/O floor {nb / 2000e3:.0f} ms at 2000 "
          f"MB/s) in {time.perf_counter() - t0:.1f} s (set-up); peak "
          f"resident memory during the deploy {rss['bytes'] / 1e9:.3f} GB "
          f"above its {rss['base'] / 1e9:.3f} GB before "
          f"({rss['bytes'] / unit:.2f}x the largest unit's f32 "
          f"{unit / 1e9:.3f} GB)")
    need(rss["bytes"] <= DEPLOY_RSS_UNITS * unit,
         f"{cfg.name}: the deploy's resident memory rose "
         f"{rss['bytes'] / 1e9:.3f} GB, beyond {DEPLOY_RSS_UNITS} x the "
         f"largest unit's f32 {unit / 1e9:.3f} GB")
    return store


def leaf_counts(store, name: str) -> tuple:
    """(int8 leaves, other leaves) of a deployed model: under
    ``apply_dtype`` each is one ``weight_transform`` launch at A."""
    n_q = int8_leaves(store, name)
    n = sum(len(u["extents"])
            for u in store.manifest(name)["units"].values())
    return n_q, n - n_q


def cicada_load(model, store, name: str, batch, label: str, **kw) -> dict:
    """One cicada cold start after the engine's warm-up, its logits
    answered inside the final E (the greedy first token taken there);
    the warm forward on the assembled params against the in-pipeline
    logits.  Returns the load, the first token with its time, and the
    launches of the load and of the warm forward."""
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    eng = ColdStartEngine(model, name, store, strategy="cicada", **kw)
    eng.warmup(batch)
    first = []
    before = ops.registry.dispatch_snapshot()
    res = eng.load(batch, on_logits=lambda lg: first.append(
        (int(lg[0, -1].float().argmax()), time.monotonic())))
    load = delta(before)
    tr = res.trace
    need(len(first) == 1, f"{label}: on_logits did not fire once")
    e_final = tr.events_for("E")["final"]
    need(e_final.t_start <= first[0][1] <= e_final.t_end,
         f"{label}: logits not answered inside the final E")
    logits = res.logits
    rows = sum(v.shape[1] for v in batch.values())    # image rows + tokens
    need(tuple(logits.shape) == (1, rows, model.cfg.vocab_size) and
         bool(torch.isfinite(logits.float()).all()),
         f"{label}: logits {tuple(logits.shape)} not finite/shaped")
    before = ops.registry.dispatch_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm, _ = model.forward(res.params, batch_dev(batch, model.device))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    fwd = delta(before)
    diff = (warm.float() - logits.float()).abs().max().item()
    scale = logits.float().abs().max().item()
    summ = tr.summary()
    print(f"  {label}: load {tr.total_time() * 1e3:.1f} ms, utilization "
          f"{tr.utilization():.1%}, logits at {(first[0][1] - tr.t0) * 1e3:.1f}"
          f" ms (greedy first token {first[0][0]}), resident params "
          f"{param_bytes(res.params) / 1e6:.1f} MB; warm forward "
          f"{warm_ms:.1f} ms (host clock), max abs diff {diff:.3e} from the "
          f"in-pipeline logits (max |logit| {scale:.3f}); launches in the "
          f"load {nonzero(load)}, in the warm forward {nonzero(fwd)}")
    print("  stage work (s): " + ", ".join(
        f"{k[5:]} {summ[k]:.3f}" for k in ("work_L", "work_R", "work_A",
                                           "work_E"))
          + f"; waits (s): A {summ['wait_A']:.3f}, E {summ['wait_E']:.3f}")
    need(diff <= BF16_ATOL * max(1.0, scale),
         f"{label}: warm forward differs from in-pipeline logits")
    return {"res": res, "first": first[0], "load": load, "forward": fwd,
            "diff": diff}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_expert_transform(store, name: str, unit: str, leaf: str,
                           timed: bool = True):
    """``weight_transform`` on one 3-D expert leaf as A applies it (the
    int8 (E, d, f) values as (E * d, f) rows, one scale over f), against
    its plain version, bit for bit, and timed (outside every path's
    count; not where phase 3 times the shape)."""
    import torch
    from repro_torch.kernels import weight_transform as wmod
    from repro_torch.store.store import WeightStore
    # the leaf alone, without the simulated device's 2000 MB/s
    q, s = (t.cuda() for t in WeightStore(store.root).read_leaf_slice(
        name, unit, leaf, None))
    got = wmod.weight_transform(q, s, out_dtype=torch.bfloat16)
    same = torch.equal(got, wmod.plain(q, s, out_dtype=torch.bfloat16))
    print(f"  weight_transform on {unit}/{leaf} int8 {tuple(q.shape)} "
          f"-> bf16: {'exact' if same else 'MISMATCH'} against plain")
    need(same, f"weight_transform {leaf} differs from its plain version")
    del got
    n, m = q.shape
    if timed:
        extra_line("weight_transform", f"expert leaf int8 ({n},{m}) -> bf16",
                   lambda: wmod.weight_transform(q, s,
                                                 out_dtype=torch.bfloat16),
                   lambda: wmod.plain(q, s, out_dtype=torch.bfloat16),
                   lambda: (q.float() * s).to(torch.bfloat16),
                   cost_bound("weight_transform", q, s,
                              out_dtype=torch.bfloat16, peak=torch.float32),
                   "(w.float() * s).to(dt)")
    del q, s
    torch.cuda.empty_cache()


def lm_counts(cfg) -> tuple:
    """Launches per forward or prefill, and per decode step, of a uniform
    attention stack: one flash / decode attention a layer, and rmsnorm
    twice a layer and once at the end where the norm is rmsnorm."""
    L = cfg.n_layers
    fwd = {"flash_attention": L}
    step = {"decode_attention": L}
    if cfg.norm == "rmsnorm":
        fwd["rmsnorm"] = step["rmsnorm"] = 2 * L + 1
    return fwd, step


def quant_products(cfg) -> int:
    """``quant_matmul`` launches per int8-resident forward or step of an
    MoE LM: 4 attention products a layer, 3 a layer per expert (the
    router is dequantized, no launch), 3 for a dense residual, and the
    head."""
    per_layer = 4 + 3 * cfg.n_experts + (3 if cfg.dense_residual else 0)
    return cfg.n_layers * per_layer + 1


def kernel_profile(fn, calls: int = 3) -> tuple:
    """Device time and launches per call of ``fn`` from a torch.profiler
    trace of ``calls`` calls (after one untraced call): (device ms,
    launches, [(kernel, launches, device ms), ...] by device time).  The
    device events only, so the CPU ops' time of their kernels is not
    counted twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        n, t = by.get(ev.name, (0, 0.0))
        by[ev.name] = (n + 1, t + us)
    rows = sorted(((k, n / calls, t / 1e3 / calls)
                   for k, (n, t) in by.items()), key=lambda r: -r[2])
    return (sum(r[2] for r in rows), sum(r[1] for r in rows), rows)


def mixtral_costs(model, steps: dict, prefill=None, floor_ms=None):
    """What an MoE step and a long prefill spend: one decode step at B = 4
    (positions 37/64/100/128 of a 256-slot cache) on each of ``steps``'
    params (label -> params), its host ms per eager call beside its device
    ms and launches from a profiler trace, with the kernels that take most
    of the device time (and ``floor_ms``, the step's byte floor, beside
    them); then, given ``prefill`` params, the router's fixed-order tree
    against one ``x @ w`` over a 4096-token prompt at mixtral's width (d
    4096, 8 experts) and at arctic-480b's (d 7168, 128 experts, its peak
    memory), and one 4096-token prefill forward on them.  Measurements
    only: their launches are outside every path's count."""
    import torch
    from repro_torch.models import moe
    cfg = model.cfg
    dev = model.device
    tok = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    pos = torch.tensor([37, 64, 100, 128], dtype=torch.int32, device=dev)
    floor = "" if floor_ms is None else (
        f"; the byte floor (every weight read once at 3.35 TB/s) "
        f"{floor_ms:.3f} ms")
    with torch.no_grad():
        for label, params in steps.items():
            cache = model.init_cache(4, 256)

            def step():
                model.decode_step(params, cache, tok, pos)
            host = call_ms(step, iters=10, warm=2)
            dev_ms, n, rows = kernel_profile(step)
            top = "; ".join(f"{k[:48]} x{c:g} {t:.3f} ms"
                            for k, c, t in rows[:6])
            print(f"  decode step at B=4, {cfg.n_layers} layers, {label}: "
                  f"{host:.3f} ms per eager call (CUDA events), device "
                  f"{dev_ms:.3f} ms in {n:g} launches (profiler){floor}; "
                  f"most device time: {top}")
            need(dev_ms > 0, f"{cfg.name} {label}: the profiler saw no "
                 f"device time")
            del cache
        if prefill is None:
            torch.cuda.empty_cache()
            return
        g = torch.Generator(device=dev).manual_seed(3)
        for d, E in ((cfg.d_model, cfg.n_experts), (7168, 128)):
            x = torch.randn(1, 4096, d, generator=g, device=dev)
            w = torch.randn(d, E, generator=g, device=dev)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            moe._router_logits(x, w)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            tree = call_ms(lambda: moe._router_logits(x, w), iters=3, warm=1)
            mm = call_ms(lambda: x @ w, iters=3, warm=1)
            print(f"  router logits over 4096 tokens, d {d}, {E} experts: "
                  f"fixed-order tree {tree:.3f} ms per eager call, peak "
                  f"{peak / 1e6:.1f} MB above its inputs; one f32 x @ w "
                  f"{mm:.4f} ms")
            del x, w
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 4096),
                                         generator=g, device=dev)}
        fwd = call_ms(lambda: model.forward(prefill, batch), iters=2, warm=1)
        print(f"  prefill forward of 4096 tokens, bf16, {cfg.n_layers} "
              f"layers: {fwd:.1f} ms per eager call")
    torch.cuda.empty_cache()


def streamed_logits(model, params, batch, forced=None) -> dict:
    """The f32 and the bf16 forward of int8-resident ``params`` over
    ``batch`` where no whole load at either dtype fits the card: a unit
    at a time, in ``unit_names()`` order, each unit dequantized from
    ``params`` at f32 and at bf16 (``QuantLeaf.astype``, the plain
    ``weight_transform``; other leaves cast, as ``apply_dtype`` casts
    them), applied with ``LM.unit_apply`` to that dtype's hidden state,
    then freed: what a load of the store at that dtype would answer.
    Returns {dtype: logits}.  ``forced``: a list that gets, block by
    block, :func:`forced_reading` of the bf16 unit and of the
    int8-resident one (``params``' own, through ``model``) applied to the
    f32 forward's input of that block, against its f32 output.  A check:
    its launches are outside every path's count."""
    import torch
    from repro_torch import quant
    from repro_torch import tree as tree_util
    from repro_torch.models import transformer
    blocks = [p for _, p in model._layers(params["blocks"])]
    f32, bf16 = torch.float32, torch.bfloat16
    runs = {}
    for dt in (f32, bf16):
        runs[dt] = (transformer.build(dataclasses.replace(
            model.cfg, compute_dtype=dt), device=model.device),
            {"batch": batch_dev(batch, model.device)})
    for name in model.unit_names():
        up = (params[name] if name in ("embed", "final")
              else blocks[int(name.split("_")[1])])
        units = {dt: tree_util.unflatten(up, {
            "/".join(path): (leaf.astype(dt) if quant.is_quant(leaf)
                             else leaf.to(dt))
            for path, leaf in tree_util.leaves_with_path(up)})
            for dt in runs}
        if forced is not None and name.startswith("block_"):
            (m32, s32), (m16, _) = runs[f32], runs[bf16]
            teacher = dict(s32, x=s32["x"].to(bf16))
            outs, weights = {}, {}
            for key, (m, unit, state) in {
                    "f32": (m32, units[f32], s32),
                    "bf16": (m16, units[bf16], teacher),
                    "int8": (model, up, teacher)}.items():
                with route_spy() as spy:
                    outs[key] = m.unit_apply(name, unit, state)
                weights[key] = spy.weights
            forced.append(forced_reading(model.cfg, name, outs, weights))
            runs[f32] = (m32, outs.pop("f32"))
            del outs, teacher
            runs[bf16] = (m16, m16.unit_apply(name, units[bf16],
                                              runs[bf16][1]))
        else:
            for dt, (m, state) in runs.items():
                runs[dt] = (m, m.unit_apply(name, units[dt], state))
        del units
    return {dt: state["logits"] for dt, (_, state) in runs.items()}


def forced_reading(cfg, name: str, outs: dict, weights: dict) -> dict:
    """One block of :func:`streamed_logits`' teacher-forced comparison:
    the bf16 and the int8-resident outputs against the f32 one, at the
    tokens whose experts every router call of the three kept alike
    (:func:`keep_pattern`; a token another kept differently carries other
    experts' outputs, whatever the arithmetic): their count, and each
    output's largest and root-mean-square distance there."""
    import torch
    kept = {k: torch.cat([keep_pattern(cfg, w) for w in ws], dim=1)
            for k, ws in weights.items()}
    agree = ((kept["f32"] == kept["bf16"]) &
             (kept["f32"] == kept["int8"])).all(dim=-1)          # (B, S)
    y32 = outs["f32"]["x"]
    mask = agree.to(y32.device)
    out = {"block": name, "agree": int(agree.sum()),
           "tokens": agree.numel()}
    for k in ("bf16", "int8"):
        d = (outs[k]["x"].float() - y32)[mask]
        out[k] = ((d.abs().max().item(), d.pow(2).mean().sqrt().item())
                  if d.numel() else (float("nan"), float("nan")))
    return out


# the share of a block's tokens whose kept experts the f32, bf16 and
# int8-resident router calls must share in the teacher-forced comparison
FORCED_AGREE = 0.5


def hold_layers(label: str, readings: list):
    """:func:`streamed_logits`' teacher-forced readings held block by
    block: at least FORCED_AGREE of the tokens keep the same experts in
    all three runs, and there the int8-resident output's root-mean-square
    distance from the f32 one is at most 1.1x the bf16 unit's (its weights
    are not rounded to bf16).  The largest distances are printed, not
    held: a maximum over one block's elements swings by a tenth either
    way (at smoke size on the CPU, 0.7x-1.1x block by block), the root
    mean square does not."""
    agree = min(r["agree"] / r["tokens"] for r in readings)
    ratio = max(r["int8"][1] / r["bf16"][1] for r in readings)
    worst = max(readings, key=lambda r: r["int8"][1] / r["bf16"][1])
    e_q = max(r["int8"][0] for r in readings)
    e_16 = max(r["bf16"][0] for r in readings)
    print(f"  {label}, block by block from the f32 forward's input "
          f"({len(readings)} blocks, tokens whose kept experts all three "
          f"share: at least {agree:.3f} of each block's): int8-resident "
          f"rms distance at most {ratio:.3f}x the bf16 unit's (at "
          f"{worst['block']}: {worst['int8'][1]:.3e} against "
          f"{worst['bf16'][1]:.3e}); largest distance int8-resident "
          f"{e_q:.3e}, bf16 {e_16:.3e}")
    for r in readings:
        need(r["agree"] >= FORCED_AGREE * r["tokens"],
             f"{label} {r['block']}: {r['agree']} of {r['tokens']} tokens "
             f"keep the same experts in the f32, bf16 and int8 runs")
        need(r["int8"][1] <= 1.1 * r["bf16"][1],
             f"{label} {r['block']}: int8-resident rms distance "
             f"{r['int8'][1]:.3e} beyond 1.1x the bf16 unit's "
             f"{r['bf16'][1]:.3e}")


# the streamed f32 forward against the f32-at-A load of the same store, of
# max |logit|, where the two are not bit-equal
STREAMED_TOL = 1e-6


def check_streamed(model, params_q, store, name: str, batch):
    """The streamed oracle (:func:`streamed_logits`) held to the cicada
    load of the same int8 store with f32 at A: its f32 logits bit-equal
    (the same dequantized values through the same units), or within
    STREAMED_TOL of max |logit|."""
    import torch
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    streamed = streamed_logits(model, params_q, batch)[torch.float32]
    torch.cuda.synchronize()
    s_ms = (time.perf_counter() - t0) * 1e3
    model32 = transformer.build(dataclasses.replace(
        model.cfg, compute_dtype=torch.float32))
    f32 = cicada_load(model32, store, name, batch,
                      "cicada, f32 at A (the streamed oracle's check)")
    want = f32["res"].logits
    del f32
    same = torch.equal(streamed, want)
    d = (streamed - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"  streamed f32 forward ({s_ms:.1f} ms, host clock) against the "
          f"f32-at-A load of {name}: "
          + ("bit-equal" if same else
             f"NOT bit-equal, max abs diff {d:.3e} ({d / scale:.3e} of "
             f"max |logit| {scale:.3f}; limit {STREAMED_TOL})"))
    need(same or d <= STREAMED_TOL * scale,
         f"{name}: the streamed f32 logits differ from the f32-at-A load's "
         f"by {d:.3e}")
    del streamed, want
    torch.cuda.empty_cache()


def mixtral_family(dev, workdir: str) -> dict:
    """Phase 20: mixtral-8x7b at full width, MIXTRAL_LAYERS layers, from
    an int8 store: the cicada cold start with bf16 at A and the
    int8-resident one, 32 greedy tokens, the slotted scheduler on the bf16
    params (tokens equal ``reference_generate``'s; the int8-resident one
    runs at 32 layers in phase 32), the rows probe on a decode step of
    each, what a step and a long prefill spend (:func:`mixtral_costs`),
    the streamed oracle held to an f32-at-A load (:func:`check_streamed`)
    and the card's memory returned."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import reference_generate

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              n_layers=MIXTRAL_LAYERS)
    model = transformer.build(cfg)
    store = deploy_int8(model, workdir, "mixtral-int8")
    n_q, n_other = leaf_counts(store, "mixtral-int8")
    check_expert_transform(store, "mixtral-int8", "block_000",
                           "moe/experts/wg")
    per_fwd, per_step = lm_counts(cfg)
    n_qm = quant_products(cfg)
    print(f"  kernels per forward {per_fwd}, per decode step {per_step}; "
          f"int8-resident: quant_matmul {n_qm} per forward and step; bf16 "
          f"at A: weight_transform {n_q + n_other} per load ({n_q} int8 "
          f"leaves, {n_other} f32 leaves cast)")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    prompts = [prompt[0][:n] for n in (37, 64, 100, 128)]
    mem0 = settled_memory()

    ops.registry.reset_counts()
    cast = cicada_load(model, store, "mixtral-int8", batch, "cicada, bf16 "
                       "at A", apply_dtype=torch.bfloat16)
    need_counts(cast["load"], {**per_fwd, "weight_transform": n_q + n_other,
                               "quant_matmul": 0}, "mixtral bf16-at-A load")
    need_counts(cast["forward"], {**per_fwd, "quant_matmul": 0},
                "mixtral bf16 warm forward")
    quant = cicada_load(model, store, "mixtral-int8", batch,
                        "cicada, int8-resident (compute_quant)",
                        compute_quant=True)
    need_counts(quant["load"], {**per_fwd, "quant_matmul": n_qm,
                                "weight_transform": 0},
                "mixtral int8-resident load")
    need_counts(quant["forward"], {**per_fwd, "quant_matmul": n_qm},
                "mixtral int8-resident warm forward")
    pb, pq = cast["res"].params, quant["res"].params
    print(f"  resident params: bf16 {param_bytes(pb) / 1e9:.3f} GB, "
          f"int8-resident {param_bytes(pq) / 1e9:.3f} GB "
          f"({param_bytes(pq) / param_bytes(pb):.3f}x)")
    before = ops.registry.dispatch_snapshot()
    t0 = time.perf_counter()
    toks = reference_generate(model, pb, prompt[0], n_new=32)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    need_counts(delta(before), {k: per_fwd.get(k, 0) + 31 * per_step.get(
        k, 0) for k in set(per_fwd) | set(per_step)},
                "mixtral reference_generate")
    need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
         f"mixtral: bad tokens {toks}")
    print(f"  reference_generate, bf16, prompt 128: 32 greedy tokens in "
          f"{gen_ms:.1f} ms (host clock, prefill + 31 decode steps): {toks}")
    # the int8-resident scheduler runs at 32 layers in phase 32
    run = run_scheduler(model, pb, prompts, cast["first"], per_fwd,
                        per_step, "mixtral bf16")
    path = ops.registry.dispatch_snapshot()
    transform_share(store, "mixtral-int8", torch.bfloat16,
                    cast["res"].trace.summary()["work_A"],
                    cast["load"]["weight_transform"])
    check_tokens("mixtral bf16", prompts, run["tokens"],
                 [toks if len(p) == 128 else
                  reference_generate(model, pb, p, n_new=32)
                  for p in prompts])
    for label, params in (("bf16", pb), ("int8", pq)):
        rows_probe(model, params, prompts, f"mixtral {label}")
    mixtral_costs(model, {"bf16": pb, "int8-resident": pq}, prefill=pb)
    check_streamed(model, pq, store, "mixtral-int8", batch)
    out = {"launches": path,
           "kernels": ("flash_attention", "decode_attention", "quant_matmul",
                       "weight_transform", "rmsnorm"),
           "store": store}
    del cast, quant, pb, pq, params
    mem1 = settled_memory()
    print(f"  memory_allocated {mem1 / 1e6:.1f} MB after the phase against "
          f"{mem0 / 1e6:.1f} MB before its loads")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"mixtral: {(mem1 - mem0) / 1e6:.1f} MB not returned")
    return out


@contextlib.contextmanager
def route_spy():
    """Records every router call while it is open, in call order (one per
    MoE layer of a forward or a prefill chunk), on the host: its
    probabilities (B, S, E) in ``.probs`` and its sparse top-k weights
    ``w_te`` (B, S, E) in ``.weights``."""
    import types
    from repro_torch.models import moe
    real, rec = moe.route, types.SimpleNamespace(probs=[], weights=[])

    def route(cfg, w, x):
        out = real(cfg, w, x)
        rec.weights.append(out[0].float().cpu())
        rec.probs.append(out[1].float().cpu())
        return out
    moe.route = route
    try:
        yield rec
    finally:
        moe.route = real


def keep_pattern(cfg, w_te):
    """The (token, expert) pairs one MoE call keeps, (B, S, E) bool, from
    its sparse weights ``w_te`` (B, S, E) as ``moe.moe_block`` selects
    them: per (row, expert) the top ``moe.capacity(cfg, S)`` tokens by
    weight (``moe.top_k``, the lower index first among equal weights),
    of which those with weight 0 (not chosen) carry nothing."""
    import torch
    from repro_torch.models import moe
    B, S, E = w_te.shape
    g, idx = moe.top_k(w_te.transpose(1, 2), moe.capacity(cfg, S))
    kept = torch.zeros((B, E, S), dtype=torch.bool)
    kept.scatter_(2, idx, g > 0)
    return kept.transpose(1, 2)


def dropped_tokens(w_te, kept) -> int:
    """Tokens of which at least one chosen expert (weight > 0) was over
    its capacity."""
    return int(((w_te > 0) & ~kept).any(dim=-1).sum())


def routing_agreement(card, cpu, k: int) -> tuple:
    """Share of the (token, expert) choices of every layer that the card
    and the CPU share, and the largest routing-weight gap (the CPU's
    k-th against its (k+1)-th probability) at a token whose choices
    differ (0 if none does)."""
    import torch
    from repro_torch.models import moe
    same = total = 0
    gap = 0.0
    for pc, pp in zip(card, cpu):
        ic = moe.top_k(pc, k)[1].reshape(-1, k)
        vp, ip = moe.top_k(pp, k + 1)
        vp, ip = vp.reshape(-1, k + 1), ip.reshape(-1, k + 1)[:, :k]
        for t in range(ic.shape[0]):
            shared = len(set(ic[t].tolist()) & set(ip[t].tolist()))
            same += shared
            total += k
            if shared < k:
                gap = max(gap, float(vp[t, k - 1] - vp[t, k]))
    return same / max(total, 1), gap


def mixtral_card_vs_cpu(workdir: str, mix: dict):
    """Phase 21: the same MIXTRAL_LAYERS layers at f32 compute, from phase
    20's int8 store dequantized to f32 at A (no 12.7 GB f32 store), on
    the card and on the CPU: logits within 2e-3, the routers' choices
    compared (a difference allowed only at a near-tie of the routing
    weights), CPU_TOKENS greedy tokens checked by ``margin_ok``."""
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving.decode import reference_generate

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              n_layers=MIXTRAL_LAYERS,
                              compute_dtype=torch.float32)
    store = mix["store"]
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 64))
    got = {}
    for side, d in (("card", None), ("cpu", "cpu")):
        m = transformer.build(cfg, device=d)
        t0 = time.perf_counter()
        with route_spy() as spy:
            res = ColdStartEngine(m, "mixtral-int8", store, strategy="cicada",
                                  device=d).load({"tokens": torch.as_tensor(
                                      prompt)})
        toks = reference_generate(m, res.params, prompt[0],
                                  n_new=CPU_TOKENS, device=d)
        got[side] = (res.logits.float().cpu(), toks, res.params, spy.probs,
                     m)
        print(f"  {side}: f32 load and {CPU_TOKENS} greedy tokens in "
              f"{time.perf_counter() - t0:.1f} s (host clock)")
    a, b = got["card"][0], got["cpu"][0]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    share, gap = routing_agreement(got["card"][3], got["cpu"][3], cfg.top_k)
    print(f"  mixtral {cfg.n_layers} layers full width f32: card vs CPU "
          f"logits max rel diff {rel:.3e} (tol 2e-3); (token, expert) "
          f"choices shared {share:.4%} over {len(got['cpu'][3])} routers, "
          f"largest routing-weight gap at a differing choice {gap:.3e} "
          f"(near-tie limit {ROUTE_TIE})")
    need(len(got["card"][3]) == len(got["cpu"][3]) == cfg.n_layers,
         "mixtral: a router was not recorded on each side")
    need(rel <= 2e-3, f"mixtral: card and CPU logits differ by {rel}")
    need(gap <= ROUTE_TIE, f"mixtral: an expert choice differs away from a "
         f"near-tie (gap {gap})")
    ta, tb = got["card"][1], got["cpu"][1]
    print(f"  {CPU_TOKENS} greedy tokens card {ta}\n"
          f"                     cpu  {tb}")
    need(margin_ok(got["cpu"][4], got["cpu"][2], prompt[0], tb, ta, 2e-3,
                   "mixtral card vs CPU"),
         "mixtral: greedy tokens differ away from a near-tie")


def arctic_smoke(dev, workdir: str) -> dict:
    """Phase 22: arctic-480b smoke (8 experts and the dense residual) at
    f32, one store on the card and the CPU: logits within 2e-3, greedy
    tokens by ``margin_ok``; then the paged scheduler with 16-token pages
    on the card, prefix hits, tokens equal ``reference_generate``'s."""
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                     reference_generate)
    from repro_torch.store.store import WeightStore, deploy_model

    cfg = dataclasses.replace(get_config("arctic-480b", smoke=True),
                              compute_dtype=torch.float32)
    cpu_model = transformer.build(cfg, device="cpu")
    gpu_model = transformer.build(cfg)
    store = WeightStore(os.path.join(workdir, "arctic-smoke"))
    deploy_model(store, cpu_model, "arctic", seed=1)
    base = np.random.default_rng(3).integers(0, cfg.vocab_size, (48,))
    per_fwd, per_step = lm_counts(cfg)
    ops.registry.reset_counts()
    got = {}
    for side, m, d in (("card", gpu_model, None), ("cpu", cpu_model, "cpu")):
        res = ColdStartEngine(m, "arctic", store, strategy="cicada",
                              device=d).load({"tokens": torch.as_tensor(
                                  base[None])})
        toks = reference_generate(m, res.params, base, n_new=16, device=d)
        got[side] = (res.logits.float().cpu(), toks, res.params)
    a, b = got["card"][0], got["cpu"][0]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"  arctic-480b smoke ({cfg.n_experts} experts, dense residual) "
          f"f32: card vs CPU logits max rel diff {rel:.3e} (tol 2e-3)")
    need(rel <= 2e-3, f"arctic: card and CPU logits differ by {rel}")
    ta, tb = got["card"][1], got["cpu"][1]
    print(f"  16 greedy tokens card {ta}\n                      cpu  {tb}")
    need(margin_ok(cpu_model, got["cpu"][2], base, tb, ta, 2e-3,
                   "arctic card vs CPU"),
         "arctic: greedy tokens differ away from a near-tie")
    params = got["card"][2]
    prompts = [base[:n] for n in (37, 40, 45, 48)]
    specs = [GenerateSpec(prompt=p, n_new=16) for p in prompts]
    sched = DecodeScheduler(gpu_model, params, n_slots=4, cache_len=128,
                            kv_page_tokens=16)
    need(gpu_model.paged_kinds() == ["moe"] and
         gpu_model.supports_prefix_cache, "arctic does not page its KV")
    before = ops.registry.dispatch_snapshot()
    lead = sched.generate(specs[3])      # publishes the shared prefix pages
    rest = run_concurrent(sched, specs[:3], {})
    torch.cuda.synchronize()
    st = sched.stats()
    launched = delta(before)
    path = ops.registry.dispatch_snapshot()
    print(f"  paged scheduler: {st['steps']} steps, prefix hits "
          f"{st['kv_prefix_hits']} pages, misses {st['kv_prefix_misses']}; "
          f"launches {nonzero(launched)}")
    need(st["kv_prefix_hits"] > 0 and st["kv_pages_pinned"] == 0,
         f"arctic paged stats {st}")
    need(launched["decode_attention_paged"] == cfg.n_layers * st["steps"],
         f"arctic: decode_attention_paged launched "
         f"{launched['decode_attention_paged']} times in {st['steps']} steps")
    sched.kvpool.check_invariants()
    for p, r in zip(prompts, rest + [lead]):
        ref = reference_generate(gpu_model, params, p, n_new=16)
        same = r.tokens == ref
        print(f"  prompt {len(p)}: paged tokens "
              f"{'equal to' if same else 'DIFFER from'} reference_generate")
        need(same, f"arctic paged prompt {len(p)} differs from "
             f"reference_generate at token {first_diff(ref, r.tokens)}")
    return {"launches": path,
            "kernels": ("flash_attention", "decode_attention",
                        "decode_attention_paged", "rmsnorm")}


def hubert_family(dev, workdir: str) -> dict:
    """Phase 23: hubert-xlarge at full width (48 encoder layers, dh 80 in
    the dh-128 instances, non-causal), int8 store, cicada with bf16 at A
    on a (1, HUBERT_FRAMES, 512) frame batch and a warm one-shot forward;
    then 4 layers at f32 on the card and the CPU from one store."""
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import example_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.store.store import WeightStore, deploy_model

    cfg = get_config("hubert-xlarge")
    model = transformer.build(cfg)
    store = deploy_int8(model, workdir, "hubert-int8")
    n_q, n_other = leaf_counts(store, "hubert-int8")
    batch = example_batch(cfg, HUBERT_FRAMES)
    per_fwd, _ = lm_counts(cfg)
    ops.registry.reset_counts()
    load = cicada_load(model, store, "hubert-int8", batch, "cicada, bf16 at "
                       "A", apply_dtype=torch.bfloat16)
    path = ops.registry.dispatch_snapshot()
    need_counts(load["load"], {**per_fwd, "weight_transform": n_q + n_other,
                               "rmsnorm": 0, "quant_matmul": 0},
                "hubert load")
    need_counts(load["forward"], per_fwd, "hubert one-shot forward")
    need(tuple(load["res"].logits.shape) == (1, HUBERT_FRAMES,
                                             cfg.vocab_size),
         "hubert: logits are not one row a frame")
    del load
    cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype=torch.float32)
    cpu_model = transformer.build(cfg4, device="cpu")
    st4 = WeightStore(os.path.join(workdir, "hubert4"))
    deploy_model(st4, cpu_model, "h4", seed=1)
    got = {}
    for side, d in (("card", None), ("cpu", "cpu")):
        m = transformer.build(cfg4, device=d)
        got[side] = ColdStartEngine(m, "h4", st4, strategy="cicada",
                                    device=d).load(batch).logits.float().cpu()
    a, b = got["card"], got["cpu"]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    top = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"  hubert 4 layers full width f32: card vs CPU logits max rel "
          f"diff {rel:.3e} (tol 2e-3), per-frame top-1 equal at {top:.2%}")
    need(rel <= 2e-3, f"hubert: card and CPU logits differ by {rel}")
    return {"launches": path, "kernels": ("flash_attention",
                                          "weight_transform")}


def vlm_greedy(model, params, batch, n_new: int,
               cache_len: int = 256) -> list:
    """Greedy tokens of a VLM request (image rows, then tokens): the
    prefill over both, then decode steps at positions counted past the
    image rows."""
    import torch
    dev = model.device
    b = batch_dev(batch, dev)
    S = b["img"].shape[1] + b["tokens"].shape[1]
    cache = model.init_cache(1, cache_len)
    lg, cache = model.prefill(params, b, cache)
    out = [int(lg[0, -1].float().argmax())]
    for t in range(S, S + n_new - 1):
        lg, cache = model.decode_step(
            params, cache, torch.tensor([[out[-1]]], device=dev),
            torch.tensor([t], dtype=torch.int32, device=dev))
        out.append(int(lg[0, -1].float().argmax()))
    return out


def internvl_family(dev, workdir: str) -> dict:
    """Phase 24: internvl2-76b at full width, INTERNVL_LAYERS layers, int8
    store: cicada with bf16 at A on 8 image rows and 56 tokens, 16 greedy
    tokens; then the card against the CPU at f32 from the same store."""
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import example_batch
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config

    cfg = dataclasses.replace(get_config("internvl2-76b"),
                              n_layers=INTERNVL_LAYERS)
    model = transformer.build(cfg)
    store = deploy_int8(model, workdir, "internvl2-int8")
    n_q, n_other = leaf_counts(store, "internvl2-int8")
    batch = example_batch(cfg, 64)
    per_fwd, per_step = lm_counts(cfg)
    ops.registry.reset_counts()
    load = cicada_load(model, store, "internvl2-int8", batch, "cicada, bf16 "
                       "at A", apply_dtype=torch.bfloat16)
    need_counts(load["load"], {**per_fwd, "weight_transform": n_q + n_other},
                "internvl2 load")
    before = ops.registry.dispatch_snapshot()
    t0 = time.perf_counter()
    toks = vlm_greedy(model, load["res"].params, batch, 16)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    path = ops.registry.dispatch_snapshot()
    need_counts(delta(before), {k: per_fwd.get(k, 0) + 15 * per_step.get(
        k, 0) for k in set(per_fwd) | set(per_step)}, "internvl2 generation")
    need(toks[0] == load["first"][0],
         "internvl2: the first greedy token is not the in-pipeline one")
    print(f"  8 image rows + 56 tokens: 16 greedy tokens in {gen_ms:.1f} ms "
          f"(host clock, prefill + 15 decode steps): {toks}")
    del load
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    got = {}
    for side, d in (("card", None), ("cpu", "cpu")):
        m = transformer.build(cfg32, device=d)
        t0 = time.perf_counter()
        res = ColdStartEngine(m, "internvl2-int8", store, strategy="cicada",
                              device=d).load(batch)
        toks = vlm_greedy(m, res.params, batch, CPU_TOKENS)
        got[side] = (res.logits.float().cpu(), toks, res.params, m)
        print(f"  {side}: f32 load and {CPU_TOKENS} greedy tokens in "
              f"{time.perf_counter() - t0:.1f} s (host clock)")
    a, b = got["card"][0], got["cpu"][0]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"  internvl2 {cfg.n_layers} layers full width f32: card vs CPU "
          f"logits max rel diff {rel:.3e} (tol 2e-3)")
    need(rel <= 2e-3, f"internvl2: card and CPU logits differ by {rel}")
    ta, tb = got["card"][1], got["cpu"][1]
    print(f"  {CPU_TOKENS} greedy tokens card {ta}\n"
          f"                     cpu  {tb}")
    need(margin_ok(got["cpu"][3], got["cpu"][2], batch["tokens"][0].numpy(),
                   tb, ta, 2e-3, "internvl2 card vs CPU",
                   extra={"img": batch["img"]}),
         "internvl2: greedy tokens differ away from a near-tie")
    return {"launches": path,
            "kernels": ("flash_attention", "decode_attention",
                        "weight_transform", "rmsnorm")}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 27: training on the card
# ---------------------------------------------------------------------------

# (B, S, H, K, dh, causal, window, dtypes): smollm-360m's training shape,
# h2o-danube-3-4b's heads and window past S, and the padded head dims;
# phase 28's dh 256 with rep 10 (recurrentgemma-2b) and dh 128 (mixtral's
# heads; internvl2's dh)
BWD_CASES = (
    (8, 512, 15, 5, 64, True, 0, ("bfloat16",)),
    (1, 4352, 32, 8, 120, True, 4096, ("bfloat16",)),
    (2, 128, 15, 5, 64, True, 0, ("float32",)),
    (2, 100, 6, 2, 20, True, 0, ("bfloat16", "float32")),
    (1, 96, 16, 16, 80, False, 0, ("bfloat16", "float32")),
    (1, 77, 4, 2, 80, False, 16, ("bfloat16", "float32")),
    (2, 200, 8, 2, 64, True, 48, ("bfloat16", "float32")),
    (1, 128, 10, 1, 256, True, 0, ("bfloat16", "float32")),
    (2, 256, 32, 8, 128, True, 0, ("bfloat16", "float32")))
# rmsnorm_bwd: smollm's training rows, a ragged row count, the widest d
NORM_BWD_CASES = ((8, 512, 960), (3, 7, 3072), (2, 3, 20), (5, 8192))
TRAIN_STEPS = 15            # the full-width run through launch/train.py


def sdpa_grads(q, k, v, do, causal: bool, window: int):
    """(dq, dk, dv) of PyTorch's SDPA on the same inputs, (B, S, H, dh)
    like the kernel's: the yardstick of bf16 rounding beside the kernel's
    errors (a boolean mask where there is a window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fmod
    S = q.shape[1]
    mask = fmod.visible(S, S, causal, window, q.device) if window else None
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
        enable_gqa=True)
    return [g.transpose(1, 2) for g in torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2))]


def check_backward_kernels(dev, report: dict):
    """The training kernels against the autograd of their plain versions
    on the card: ``flash_attention_bwd`` (fed the card forward's output
    and log-sum-exp) at :data:`BWD_CASES`, ``rmsnorm_bwd`` at
    :data:`NORM_BWD_CASES`, each gradient within 1e-4 (f32) or 2e-2
    (bf16) of its max |g|, and bit-equal across two calls, each bf16
    case's errors printed beside SDPA's backward's against the same
    reference; the forward with the log-sum-exp bit-equal to the serving
    forward.  Then both timed at smollm-360m's training shapes for the
    JSON line (each with its ratio to the library call and the bound's
    share of its time), and rmsnorm's forward at the training rows for
    rmsnorm's ``more``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import flash_attention_bwd as bmod
    from repro_torch.kernels import rmsnorm as nmod
    g = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    fl_err = {"bfloat16": 0.0, "float32": 0.0}
    for (B, S, H, K, dh, causal, win, dts) in BWD_CASES:
        for dname in dts:
            dt = getattr(torch, dname)
            tol = BF16_ATOL if dt == torch.bfloat16 else F32_ATOL
            q, do = randn(B, S, H, dh, dtype=dt), randn(B, S, H, dh, dtype=dt)
            k, v = randn(B, S, K, dh, dtype=dt), randn(B, S, K, dh, dtype=dt)
            o, lse = fmod.flash_attention(q, k, v, causal=causal,
                                          window=win, return_lse=True)
            same = torch.equal(o, fmod.flash_attention(
                q, k, v, causal=causal, window=win))
            got = bmod.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=win)
            again = bmod.flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=causal, window=win)
            qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
            want = torch.autograd.grad(
                fmod.plain(qa, ka, va, causal=causal, window=win),
                (qa, ka, va), do)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            det = all(torch.equal(a, b) for a, b in zip(got, again))
            fl_err[dname] = max(fl_err[dname], *errs)
            yard = ""
            if dt == torch.bfloat16:
                sd = sdpa_grads(q, k, v, do, causal, win)
                se = [rel_err(a, b) for a, b in zip(sd, want)]
                yard = (f"; SDPA's backward {se[0]:.2e}/{se[1]:.2e}/"
                        f"{se[2]:.2e}")
                del sd
            print(f"  flash_attention_bwd B={B} S={S} H={H} K={K} dh={dh} "
                  f"causal={causal} window={win} {dname}: dq/dk/dv err "
                  f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} of max |g| "
                  f"(tol {tol}){yard}; two calls "
                  f"{'bit-equal' if det else 'DIFFER'}; LSE forward "
                  f"{'bit-equal' if same else 'DIFFERS'} to serving")
            need(all(math.isfinite(e) and e <= tol for e in errs),
                 f"flash_attention_bwd {B, S, H, K, dh, causal, win} "
                 f"{dname}: errors {errs}")
            need(det, f"flash_attention_bwd {dname} not deterministic")
            need(same, f"flash_attention with LSE differs from serving at "
                       f"{B, S, H, K, dh} {dname}")
            del q, k, v, do, o, lse, got, again, want, qa, ka, va
    nm_err = {"bfloat16": 0.0, "float32": 0.0}
    for shape in NORM_BWD_CASES:
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            for sdt in (torch.float32, torch.bfloat16):
                x = randn(*shape, dtype=dt) * 3
                sc = (randn(shape[-1]) * 0.1).to(sdt)
                gy = randn(*shape, dtype=dt)
                got = nmod.rmsnorm_bwd(x, sc, gy)
                again = nmod.rmsnorm_bwd(x, sc, gy)
                xa, sa = x.detach().requires_grad_(), \
                    sc.detach().requires_grad_()
                want = torch.autograd.grad(nmod.plain(xa, sa), (xa, sa), gy)
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                key = str(dt).replace("torch.", "")
                nm_err[key] = max(nm_err[key], *errs)
                need(all(math.isfinite(e) and e <= tol for e in errs) and
                     got[0].dtype == dt and got[1].dtype == sdt,
                     f"rmsnorm_bwd {shape} {dt} scale {sdt}: errors {errs}")
                need(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"rmsnorm_bwd {shape} {dt} not deterministic")
    print(f"  rmsnorm_bwd {' '.join(str(s).replace(' ', '') for s in NORM_BWD_CASES)}"
          f", bf16 and f32, f32 and bf16 scales: dx/dscale err bf16 "
          f"{nm_err['bfloat16']:.2e}, f32 {nm_err['float32']:.2e} of max "
          f"|g| (tol {BF16_ATOL} / {F32_ATOL}); two calls bit-equal")
    # a row's dx does not depend on the other rows of the call
    for d, dt in ((960, torch.bfloat16), (8192, torch.float32)):
        x = randn(16, d, dtype=dt) * 3
        sc = randn(d) * 0.1
        gy = randn(16, d, dtype=dt)
        many = nmod.rmsnorm_bwd(x, sc, gy)[0]
        one = torch.cat([nmod.rmsnorm_bwd(x[i:i + 1], sc, gy[i:i + 1])[0]
                         for i in range(16)])
        same = torch.equal(many, one)
        print(f"  rmsnorm_bwd dx row independence (d {d}, "
              f"{str(dt).replace('torch.', '')}) M=16: "
              f"{'bit-equal' if same else 'DIFFERS'} to M=1")
        need(same, f"rmsnorm_bwd dx rows depend on M at d {d}")

    # timing at smollm-360m's training shapes (batch 8, seq 512)
    B, S, H, K, dh = 8, 512, 15, 5, 64
    bf = torch.bfloat16
    q, do = randn(B, S, H, dh, dtype=bf), randn(B, S, H, dh, dtype=bf)
    k, v = randn(B, S, K, dh, dtype=bf), randn(B, S, K, dh, dtype=bf)
    o, lse = fmod.flash_attention(q, k, v, causal=True, return_lse=True)
    # the package's count: 2.5 times the forward's products, each of q, k,
    # v, o, dO, lse read and dq, dk, dv written once
    b_ms, b_by = cost_bound("flash_attention_bwd", q, k, v, o, lse, do,
                            peak=bf)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    report["flash_attention_bwd"] = dict(
        max_abs_err=max(fl_err.values()),
        ms=device_ms(lambda: bmod.flash_attention_bwd(q, k, v, o, lse, do)),
        call_ms=call_ms(lambda: bmod.flash_attention_bwd(q, k, v, o, lse,
                                                         do)),
        plain_ms=device_ms(lambda: bmod.plain(q, k, v, o, lse, do)),
        library_ms=call_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True)),
        library="SDPA's backward (is_causal, enable_gqa), eager, timed by "
                "CUDA events",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q/o/dO (8,512,15,64), k/v (8,512,5,64), causal")
    sdpa_dev = sum(kernel_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True)).values())
    print(f"  SDPA's backward at that shape: its kernels {sdpa_dev:.4f} ms "
          f"of device time a call (torch.profiler)")
    del qt, kt, vt, lib_out
    x = randn(B, S, 960, dtype=bf) * 3
    sc = randn(960) * 0.1
    gy = randn(B, S, 960, dtype=bf)
    n, d = B * S, 960
    b_ms, b_by = cost_bound("rmsnorm_bwd", x, sc, gy, peak=torch.float32)
    xl = x.detach().requires_grad_()
    wl = (1.0 + sc).detach().requires_grad_()
    lib_out = F.rms_norm(xl, (d,), wl.to(bf), 1e-6)
    report["rmsnorm_bwd"] = dict(
        max_abs_err=max(nm_err.values()),
        ms=device_ms(lambda: nmod.rmsnorm_bwd(x, sc, gy)),
        call_ms=call_ms(lambda: nmod.rmsnorm_bwd(x, sc, gy)),
        plain_ms=device_ms(lambda: nmod.plain_bwd(x, sc, gy)),
        library_ms=call_ms(lambda: torch.autograd.grad(
            lib_out, (xl, wl), gy, retain_graph=True)),
        library="autograd of F.rms_norm (weight 1 + scale), eager, timed "
                "by CUDA events",
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 x/g (8,512,960), f32 scale (960,)")
    split = kernel_ms(lambda: nmod.rmsnorm_bwd(x, sc, gy), per_launch=True)
    lib_dev = kernel_ms(lambda: torch.autograd.grad(
        lib_out, (xl, wl), gy, retain_graph=True))
    report["rmsnorm_bwd"]["library_device_ms"] = sum(lib_dev.values())
    print(f"  rmsnorm_bwd's two launches (torch.profiler, the mean of a "
          f"launch): pass 1 "
          f"{sum(t for n, t in split.items() if 'reduce' not in n):.4f} "
          f"ms, pass 2 "
          f"{sum(t for n, t in split.items() if 'reduce' in n):.4f} ms; "
          f"autograd of F.rms_norm: its kernels "
          f"{sum(lib_dev.values()):.4f} ms of device time a call")
    for name in ("flash_attention_bwd", "rmsnorm_bwd"):
        r = report[name]
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms on the "
              f"device ({r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"(eager), bound {r['bound_ms']:.6f} ms ({r['bound_by']}); "
              f"kernel / library {r['ms'] / r['library_ms']:.3f}, bound / "
              f"kernel {r['bound_ms'] / r['ms']:.1%}")
    # rmsnorm's forward where training runs it (4 L + 1 launches a step)
    w = (1.0 + sc).to(bf)                  # outside the timed region
    n, d = B * S, 960
    extra_line("rmsnorm", "bf16 x (8,512,960), f32 scale (960,)",
               lambda: nmod.rmsnorm(x, sc), lambda: nmod.plain(x, sc),
               lambda: F.rms_norm(x, (d,), w, 1e-6),
               cost_bound("rmsnorm", x, sc, peak=torch.float32),
               library="F.rms_norm with weight 1 + scale made outside the "
                       "timed region")


# ---------------------------------------------------------------------------
# phase 28: training every family
# ---------------------------------------------------------------------------

# rglru_scan_bwd (B, S, W, bc, h0): recurrentgemma-2b's training shape, a
# 300-step S over chunks of 256 (through ops and autograd), a ragged width
RGLRU_BWD_CASES = ((8, 512, 2560, 256, False), (2, 300, 2560, 256, True),
                   (2, 37, 300, 16, True))
# ssd_scan_bwd (b, nh, S, dp, N, bc, h0, dtypes): mamba2-780m's training
# shape, a 300-step S over chunks of 256 (through ops and autograd), the
# f32 kernel's instances of 16 and 32 rows from a non-zero state; for the
# bf16 design a 200-step S (not a multiple of its 128-step chunks) from a
# non-zero state and a head dim of 32
SSD_BWD_CASES = ((8, 48, 512, 64, 128, 256, False, ("bfloat16", "float32")),
                 (2, 8, 300, 64, 128, 256, False, ("bfloat16", "float32")),
                 (2, 4, 77, 16, 16, 16, True, ("bfloat16", "float32")),
                 (1, 3, 50, 32, 20, 32, True, ("float32",)),
                 (2, 6, 200, 64, 128, 200, True, ("bfloat16",)),
                 (2, 4, 177, 32, 96, 177, True, ("bfloat16",)))


def ssd_bwd_bounds(b: int, nh: int, S: int, dp: int, N: int) -> tuple:
    """The least time of ``ssd_scan_bwd`` at bf16 x (b, nh, S, dp), N, and
    the counts it is taken from, by the package's ``ssd_scan.cost_bwd``:
    ((ms, by), {name: (ms, by)}).  Bytes: x, dy, dx (bf16), dt, ddt, B, C,
    dB, dC (f32), each once.  Operations: the chunked form's products at
    the bf16 rate in chunks of Q steps (``ssd_scan.bwd_products``: dy x^T
    and its product with dy for dx; the two with B and C; five of the
    state terms; C B^T once a batch row and chunk, the same for every
    head), at Q 16, 32, 64 and 128 (the design's); the least time is the
    larger of the bytes' and the fewest products'.  Beside them the f32
    count of the sequential form (12 a state element and step), the first
    design's."""
    import torch
    from repro_torch.kernels import ssd_scan as smod
    x, dt, A, B, C = ssd_meta(b, nh, S, dp, N)
    flops, nbytes = smod.cost_bwd(x, dt, A, B, C, x)
    counts = {"bytes": bound(nbytes, 0, torch.bfloat16)}
    for Q in smod.BWD_COST_CHUNKS:
        counts[f"chunked bf16 products, Q {Q}"] = bound(
            0, 2 * smod.bwd_products(b, nh, S, dp, N, Q), torch.bfloat16)
    counts["sequential f32 count"] = bound(0, 12 * b * nh * S * dp * N,
                                           torch.float32)
    return bound(nbytes, flops, torch.bfloat16), counts


def check_scan_backwards(dev, report: dict):
    """The scans' backward kernels against their plain formulas on the
    card: each output within 1e-4 of its max |g| (f32 outputs; dx of bf16
    x within 2e-2), two calls bit-equal, and for ``ssd_scan_bwd`` batch row
    0 (dx, ddt, dB, dC) bit-equal to a call of that row alone; where S is
    not a multiple of the chunk, the gradients of ``ops.ssd_scan`` /
    ``ops.rglru_scan`` (padded, through the autograd functions) against
    autograd of the plain forward.  Then both timed at the training shapes
    for the JSON line, ``ssd_scan_bwd`` beside its byte bound, the bound of
    its chunked form's products at the bf16 rate and the f32 count of the
    sequential form (its kernels' split: ``ab.py --sweep``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rmod
    from repro_torch.kernels import ssd_scan as smod
    g = torch.Generator(device=dev).manual_seed(28)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def ssd_inputs(b, nh, S, dp, N, dt_):
        return (randn(b, nh, S, dp, dtype=dt_),
                randn(b, nh, S).abs() * 0.1 + 0.01, -randn(nh).abs() - 0.1,
                randn(b, S, N) * 0.3, randn(b, S, N) * 0.3)

    def rglru_inputs(Bz, S, W):
        return (torch.rand(Bz, S, W, generator=g, device=dev) * 0.5 + 0.5,
                randn(Bz, S, W))

    def through_ops(fn, plain_fn, ins, gy, bc):
        """Gradients of ``fn`` (ops, padded, autograd functions) and of the
        plain forward's autograd, for the same cotangent."""
        a = [t.detach().requires_grad_() for t in ins]
        got = torch.autograd.grad(fn(*a, bc=bc), a, gy)
        want = torch.autograd.grad(plain_fn(*a), a, gy)
        return [rel_err(x, y) for x, y in zip(got, want)]

    worst = 0.0
    for (Bz, S, W, bc, with_h0) in RGLRU_BWD_CASES:
        a, bb = rglru_inputs(Bz, S, W)
        h0 = randn(Bz, W) if with_h0 else None
        y = rmod.rglru_scan(a, bb, h0=h0)
        gy = randn(Bz, S, W)
        got = rmod.rglru_scan_bwd(a, y, gy, h0=h0, want_dh0=with_h0)
        again = rmod.rglru_scan_bwd(a, y, gy, h0=h0, want_dh0=with_h0)
        want = rmod.plain_bwd(a, y, gy, h0=h0)
        torch.cuda.synchronize()
        pairs = [(x, w) for x, w in zip(got, want) if w is not None]
        errs = [rel_err(x, w) for x, w in pairs]
        det = all(torch.equal(x, z) for x, z in zip(got, again)
                  if x is not None)
        worst = max(worst, *errs)
        extra = ""
        if S % bc:
            e_ops = through_ops(ops.rglru_scan, rmod.plain, (a, bb), gy, bc)
            extra = (f"; through ops (bc {bc}) da/db {e_ops[0]:.2e}/"
                     f"{e_ops[1]:.2e}")
            errs += e_ops
        print(f"  rglru_scan_bwd B={Bz} S={S} W={W} h0={with_h0}: da/db"
              f"{'/dh0' if with_h0 else ''} err "
              f"{'/'.join(f'{e:.2e}' for e in errs[:len(pairs)])} of max "
              f"|g| (tol {F32_ATOL}){extra}; two calls "
              f"{'bit-equal' if det else 'DIFFER'}")
        need(all(math.isfinite(e) and e <= F32_ATOL for e in errs),
             f"rglru_scan_bwd {Bz, S, W}: errors {errs}")
        need(det, f"rglru_scan_bwd {Bz, S, W} not deterministic")
    names = ("dx", "ddt", "dA", "dB", "dC")
    s_worst = 0.0
    for (b, nh, S, dp, N, bc, with_h0, dts) in SSD_BWD_CASES:
        for dname in dts:
            dt_ = getattr(torch, dname)
            x, dt, A, B, C = ssd_inputs(b, nh, S, dp, N, dt_)
            h0 = randn(b, nh, dp, N) * 0.5 if with_h0 else None
            dy = randn(b, nh, S, dp, dtype=dt_)
            got = smod.ssd_scan_bwd(x, dt, A, B, C, dy, h0=h0)
            again = smod.ssd_scan_bwd(x, dt, A, B, C, dy, h0=h0)
            want = smod.plain_bwd(x, dt, A, B, C, dy, h0=h0)
            torch.cuda.synchronize()
            errs = [rel_err(u, w) for u, w in zip(got, want)]
            tols = [BF16_ATOL if dt_ == torch.bfloat16 else F32_ATOL] + \
                [F32_ATOL] * 4
            det = all(torch.equal(u, z) for u, z in zip(got, again))
            one = smod.ssd_scan_bwd(
                *(t[:1].contiguous() for t in (x, dt)), A,
                *(t[:1].contiguous() for t in (B, C, dy)),
                h0=None if h0 is None else h0[:1].contiguous())
            rows = all(torch.equal(got[i][:1], one[i]) for i in (0, 1, 3, 4))
            s_worst = max(s_worst, *errs)
            extra = ""
            if S % bc:
                e_ops = through_ops(ops.ssd_scan, smod.plain,
                                    (x, dt, A, B, C), dy, bc)
                extra = (f"; through ops (bc {bc}) "
                         f"{'/'.join(f'{e:.2e}' for e in e_ops)}")
                errs += e_ops
                tols += tols
            print(f"  ssd_scan_bwd b={b} nh={nh} S={S} dp={dp} N={N} "
                  f"h0={with_h0} {dname}: {'/'.join(names)} err "
                  f"{'/'.join(f'{e:.2e}' for e in errs[:5])} of max |g| "
                  f"(tol {tols[0]} dx, {F32_ATOL} the rest){extra}; two "
                  f"calls {'bit-equal' if det else 'DIFFER'}; row 0 "
                  f"{'bit-equal' if rows else 'DIFFERS'} to b=1")
            need(all(math.isfinite(e) and e <= t for e, t in zip(errs, tols))
                 and got[0].dtype == dt_,
                 f"ssd_scan_bwd {b, nh, S, dp, N} {dname}: errors {errs}")
            need(det, f"ssd_scan_bwd {b, nh, S, dp, N} {dname} not "
                      f"deterministic")
            need(rows, f"ssd_scan_bwd {b, nh, S, dp, N} {dname}: row 0 "
                       f"depends on the other rows")
            del x, dy, got, again, want, one

    # timing at the training shapes (batch 8, seq 512)
    Bz, S, W = 8, 512, 2560
    a, bb = rglru_inputs(Bz, S, W)
    y = rmod.rglru_scan(a, bb)
    gy = randn(Bz, S, W)
    report["rglru_scan_bwd"] = dict(
        max_abs_err=worst,
        ms=device_ms(lambda: rmod.rglru_scan_bwd(a, y, gy)),
        call_ms=call_ms(lambda: rmod.rglru_scan_bwd(a, y, gy)),
        plain_ms=device_ms(lambda: rmod.plain_bwd(a, y, gy), iters=2,
                           replays=2),
        library_ms=None,
        library="none: no single PyTorch call computes a linear "
                "recurrence's gradient",
        shape="f32 a, h, g (8,512,2560)")
    report["rglru_scan_bwd"].update(zip(
        ("bound_ms", "bound_by"),
        cost_bound("rglru_scan_bwd", a, y, gy, peak=torch.float32)))
    b, nh, S, dp, N = 8, 48, 512, 64, 128
    x, dt, A, B, C = ssd_inputs(b, nh, S, dp, N, torch.bfloat16)
    dy = randn(b, nh, S, dp, dtype=torch.bfloat16)
    report["ssd_scan_bwd"] = dict(
        max_abs_err=s_worst,
        ms=device_ms(lambda: smod.ssd_scan_bwd(x, dt, A, B, C, dy), iters=5,
                     replays=3),
        call_ms=call_ms(lambda: smod.ssd_scan_bwd(x, dt, A, B, C, dy),
                        iters=5),
        plain_ms=device_ms(lambda: smod.plain_bwd(x, dt, A, B, C, dy),
                           iters=1, replays=2),
        library_ms=None,
        library="none: no single PyTorch call computes the SSD scan's "
                "gradient",
        shape="bf16 x/dy (8,48,512,64), f32 dt (8,48,512), B/C (8,512,128)")
    bnd, bounds = ssd_bwd_bounds(b, nh, S, dp, N)
    report["ssd_scan_bwd"].update(zip(("bound_ms", "bound_by"), bnd))
    report["ssd_scan_bwd"]["bounds"] = {
        k: {"bound_ms": ms, "bound_by": by} for k, (ms, by) in bounds.items()}
    print("  ssd_scan_bwd bounds: " + "; ".join(
        f"{k} {ms:.6f} ms ({by})" for k, (ms, by) in bounds.items()))
    for name in ("rglru_scan_bwd", "ssd_scan_bwd"):
        r = report[name]
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms on the "
              f"device ({r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}); bound / kernel "
              f"{r['bound_ms'] / r['ms']:.1%}")


# each block kind's forward kernel (its backward is the name + "_bwd")
KIND_KERNEL = {"attn": "flash_attention", "local_attn": "flash_attention",
               "moe": "flash_attention", "ssd": "ssd_scan",
               "rglru": "rglru_scan"}


def train_counts(model) -> dict:
    """Launches of one training step with remat: a unit's layers run their
    forward twice (once more in the backward), the tail's once; one
    backward a layer.  A layer's mixer kernel (:data:`KIND_KERNEL`) and
    its two norms (norm1 and norm2, or the SSD block's gated norm) where
    the config's norm is rmsnorm (the gated norm always is), and the
    final norm.  Every other kernel 0."""
    from repro_torch.kernels import ops
    cfg = model.cfg
    want = {n: 0 for n in ops.registry.names()}
    rms = cfg.norm == "rmsnorm"
    layers = [(k, 2) for _ in range(model.n_units) for k in model.pattern]
    layers += [(k, 1) for k in model.tail_kinds]
    for kind, runs in layers:
        want[KIND_KERNEL[kind]] += runs
        want[KIND_KERNEL[kind] + "_bwd"] += 1
        norms = int(rms) + (1 if kind == "ssd" else int(rms))
        want["rmsnorm"] += norms * runs
        want["rmsnorm_bwd"] += norms
    want["rmsnorm"] += int(rms)
    want["rmsnorm_bwd"] += int(rms)
    return want


def device_busy(fn, by_kernel: bool = False) -> tuple:
    """(wall ms, device busy ms) of one call of ``fn`` under
    torch.profiler: the union of its kernels and copies on the device;
    with ``by_kernel`` also the device ms of each kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy = union_ms([(ev.time_range.start, ev.time_range.end)
                     for ev in events])
    if not by_kernel:
        return wall, busy
    per: dict = {}
    for ev in events:
        per[ev.name] = per.get(ev.name, 0.0) + (
            ev.time_range.end - ev.time_range.start) / 1e3
    return wall, busy, per


def train_batch(data, step: int, dev, batch: int = 8, seq: int = 512):
    import torch
    return {k: torch.as_tensor(v).to(dev)
            for k, v in data.batch(batch, seq, step).items()}


def train_card_vs_cpu(dev, arch: str = "smollm-360m", n_layers: int = 4,
                      batch: int = 2, seq: int = 128):
    """Loss and every gradient leaf of ``arch`` at ``n_layers`` of full
    width, f32 compute, on the card and on the CPU from the same params
    (drawn on the card, copied) and the same Markov batch: loss within
    2e-3 relative, each leaf within 2e-3 of its max |g|."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.training.data import MarkovLM
    from repro_torch.training.train import value_and_grad
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              compute_dtype=torch.float32)
    cpu = transformer.build(cfg, device="cpu")
    card = transformer.build(cfg, device=dev)
    p_card = card.init(0)
    p_cpu = tree_util.tree_map(lambda t: t.cpu(), p_card)
    data = MarkovLM(cfg.vocab_size, seed=0)
    (l_card, _), g_card = value_and_grad(card, p_card,
                                         train_batch(data, 0, dev, batch, seq))
    (l_cpu, _), g_cpu = value_and_grad(
        cpu, p_cpu, train_batch(data, 0, torch.device("cpu"), batch, seq))
    torch.cuda.synchronize()
    worst, where = 0.0, ""
    for (path, a), b in zip(tree_util.leaves_with_path(g_card),
                            tree_util.leaves(g_cpu)):
        e = rel_err(a.cpu(), b)
        if not e <= worst:
            worst, where = e, "/".join(path)
    le = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    print(f"  card against CPU, {arch} f32 at {n_layers} layers, ({batch}, "
          f"{seq}) tokens: loss {float(l_card):.6f} / {float(l_cpu):.6f} "
          f"(rel {le:.2e}); worst gradient leaf {where} at {worst:.2e} of "
          f"its max |g| (tol 2e-3)")
    need(le <= 2e-3 and worst <= 2e-3,
         f"training card vs CPU {arch}: loss rel {le}, leaf {where} {worst}")


def training(dev, workdir: str, report: dict) -> dict:
    """Phase 27: the backward kernels against plain
    (:func:`check_backward_kernels`), the card against the CPU at 4
    layers (:func:`train_card_vs_cpu`), then full-width smollm-360m
    through ``launch/train.py``'s ``main`` with its defaults (batch 8,
    seq 512, lr 3e-3, warmup_cosine) and ``--compress-grads`` for
    :data:`TRAIN_STEPS` steps with a checkpoint at the end: every loss
    finite, the last 5 below the first, exact launches a step; then from
    that checkpoint the same 3 steps twice (bit-equal params) and 6
    straight against 3, save, restore, 3 (within 1e-6, as the
    reference's test); ms a step, tokens/s, peak memory and one step's
    device busy share.  Returns the run's launches."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.distributed.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.training.data import MarkovLM
    from repro_torch.training.optim import AdamW, AdamWState, warmup_cosine
    from repro_torch.training.train import make_train_step
    t0 = time.perf_counter()
    check_backward_kernels(dev, report)
    train_card_vs_cpu(dev, n_layers=2)
    t1 = time.perf_counter()

    cfg = get_config("smollm-360m")
    ck_dir = os.path.join(workdir, "train-ckpt")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.registry.reset_counts()
    t_run = time.perf_counter()
    hist = launch_train.main(
        ["--arch", "smollm-360m", "--steps", str(TRAIN_STEPS),
         "--compress-grads", "--ckpt-dir", ck_dir,
         "--ckpt-every", str(TRAIN_STEPS)], log_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = ops.registry.dispatch_snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = hist["loss"]
    per_step = train_counts(transformer.build(cfg, device=dev))
    print(f"    launches in {TRAIN_STEPS} steps: {nonzero(counts)}; a step: "
          f"{nonzero(per_step)}")
    need(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
         f"training losses not all finite: {losses}")
    last5 = sum(losses[-5:]) / 5
    need(last5 < losses[0], f"training loss did not fall: first "
                            f"{losses[0]}, mean of the last 5 {last5}")
    need_counts(counts, {k: v * TRAIN_STEPS for k, v in per_step.items()},
                "training run")
    tokens = 8 * 512
    step_ms = sorted(tokens / t * 1e3 for t in hist["tps"][1:])
    med = step_ms[len(step_ms) // 2]
    print(f"  full-width smollm-360m, {TRAIN_STEPS} steps of (8, 512) "
          f"tokens, --compress-grads: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (last 5 mean {last5:.4f}); step ms (steps "
          f"2-{TRAIN_STEPS}) median {med:.1f}, min {step_ms[0]:.1f}, max "
          f"{step_ms[-1]:.1f}; {tokens / med * 1e3:,.0f} tokens/s; peak "
          f"memory {peak / 2**30:.2f} GiB; run {run_s:.1f} s with the "
          f"checkpoint")

    model = transformer.build(cfg, device=dev)
    ab = model.abstract()
    step_at, p30, s30 = Checkpointer(ck_dir).restore(
        ab, AdamWState(None, ab, ab), device=dev)
    need(step_at == TRAIN_STEPS, f"checkpoint at {step_at}")
    opt = AdamW(lr=warmup_cosine(3e-3, TRAIN_STEPS // 10, TRAIN_STEPS),
                weight_decay=0.01)
    step = make_train_step(model, opt)
    data = MarkovLM(cfg.vocab_size, seed=0)

    def run(p, s, lo, hi):
        for i in range(lo, hi):
            p, s, _ = step(p, s, train_batch(data, i, dev))
        return p, s

    a0 = TRAIN_STEPS
    pa, sa = run(p30, s30, a0, a0 + 3)
    pb, _ = run(p30, s30, a0, a0 + 3)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(tree_util.leaves(pa),
                                                 tree_util.leaves(pb)))
    print(f"  the same 3 steps from the step-{a0} checkpoint twice: params "
          f"{'bit-equal' if same else 'DIFFER'}")
    need(same, "the training step is not deterministic")
    del pb
    p_straight, _ = run(pa, sa, a0 + 3, a0 + 6)
    ck2 = Checkpointer(os.path.join(workdir, "train-ckpt-resume"))
    ck2.save(a0 + 3, pa, sa)
    del pa, sa
    _, pr, sr = ck2.restore(ab, AdamWState(None, ab, ab), device=dev)
    p_resumed, _ = run(pr, sr, a0 + 3, a0 + 6)
    pairs = list(zip(tree_util.leaves(p_resumed),
                     tree_util.leaves(p_straight)))
    bit = all(torch.equal(x, y) for x, y in pairs)
    close = all(torch.allclose(x.float(), y.float(), atol=1e-6, rtol=1e-6)
                for x, y in pairs)
    err = max((x.float() - y.float()).abs().max().item() for x, y in pairs)
    print(f"  6 straight against 3, save, restore, 3: "
          f"{'bit-equal' if bit else f'max abs difference {err:.3e}'} "
          f"(tol 1e-6 + 1e-6 |x|)")
    need(close, "resume differs from the straight run")
    del p_resumed, p_straight

    wall, busy = device_busy(lambda: run(pr, sr, a0 + 3, a0 + 4))
    print(f"  one step under the profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall:.1%})")
    need(busy > 0, "training step: the profiler saw no device time")
    print(f"  phase 27: kernel checks and card vs CPU {t1 - t0:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s")
    del pr, sr, p30, s30
    torch.cuda.empty_cache()
    for d in (ck_dir, ck2.dir):             # about 5 GB each on disk
        shutil.rmtree(d, ignore_errors=True)
    return {"launches": counts, "step_ms": med, "tokens_per_s":
            tokens / med * 1e3, "peak_bytes": peak, "busy": busy / wall}


TRAIN28_STEPS = 12          # each full-width run through launch/train.py
TRAIN28_LR = "1e-3"         # its --lr
# the full-width runs: (arch, depth; the config's); the card against the
# CPU at f32: (arch, layers, batch, seq)
TRAIN28_ARCHS = ("mamba2-780m", "recurrentgemma-2b")
TRAIN28_CPU = (("mamba2-780m", 2, 1, 128), ("recurrentgemma-2b", 5, 1, 64))
# a few donated make_train_step steps of the other families: (arch, layers:
# an int cuts the full config's depth, None keeps it, "smoke" the smoke
# config; batch, seq, steps)
OTHER_FAMILIES = (("mixtral-8x7b", MIXTRAL_LAYERS, 2, 128, 3),
                  ("hubert-xlarge", None, 2, 256, 3),
                  ("internvl2-76b", 1, 2, 256, 3),
                  ("arctic-480b", "smoke", 2, 64, 3))


def tree_digest(tree):
    """Each leaf's sum of its elements' bit patterns (int64: exact, so in
    no order): equal trees give equal digests, and a change of any element
    shows but for an exact cancellation within its leaf."""
    import torch
    from repro_torch import tree as tree_util
    views = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    return torch.stack([
        t.detach().contiguous().view(views[t.element_size()]).long().sum()
        for t in tree_util.leaves(tree)])


def family_batches(cfg, dev, batch: int, seq: int, n: int) -> list:
    """The first ``n`` batches ``launch/train.py`` feeds ``cfg`` (Markov
    tokens and labels, seed 0; the audio family's frames and the VLM's
    image rows from ``family_batches``), on the card."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.training.data import MarkovLM, host_batches
    gen = launch_train.family_batches(
        cfg, host_batches(MarkovLM(cfg.vocab_size, seed=0),
                          global_batch=batch, seq=seq), seq=seq, seed=0)
    return [{k: torch.as_tensor(v).to(dev) for k, v in next(gen).items()}
            for _ in range(n)]


def first_step(model, opt, batch):
    """From the model's seed-0 init, one donated step: (loss, digest of
    params and moments), and the step function with its state."""
    from repro_torch.training.train import make_train_step
    step = make_train_step(model, opt, donate=True)
    p = model.init(0)
    s = opt.init(p)
    p, s, m = step(p, s, batch)
    return (m["loss"].clone(), tree_digest((p, s.m, s.v))), step, p, s


def same_first_step(model, opt, batch, profile: bool = False):
    """The first step twice from the same init: bit-equal loss, params and
    moments; with ``profile``, one more step under the profiler (wall ms,
    device busy ms, device ms by kernel name)."""
    import torch
    a, _, p, s = first_step(model, opt, batch)
    del p, s
    torch.cuda.empty_cache()
    b, step, p, s = first_step(model, opt, batch)
    busy = device_busy(lambda: step(p, s, batch), by_kernel=True) \
        if profile else None
    del p, s
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), busy


def full_width_run(dev, arch: str) -> tuple:
    """``launch/train.py`` on ``arch`` at full width and depth with its
    defaults (batch 8, seq 512, warmup_cosine) but ``--lr``
    :data:`TRAIN28_LR`, for :data:`TRAIN28_STEPS` steps: every loss
    finite, the mean of the last 3 below the first, exact launches a step; then the first step twice from
    the same init, bit-equal, and one step profiled.  Returns (launches,
    numbers)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.training.optim import AdamW, warmup_cosine
    cfg = get_config(arch)
    model = transformer.build(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.registry.reset_counts()
    t_run = time.perf_counter()
    hist = launch_train.main(["--arch", arch, "--steps", str(TRAIN28_STEPS),
                              "--lr", TRAIN28_LR], log_every=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = ops.registry.dispatch_snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = train_counts(model)
    losses = hist["loss"]
    print(f"    {arch}: launches in {TRAIN28_STEPS} steps "
          f"{nonzero(counts)}; a step {nonzero(per_step)}")
    need(len(losses) == TRAIN28_STEPS and all(map(math.isfinite, losses)),
         f"{arch} training losses not all finite: {losses}")
    last3 = sum(losses[-3:]) / 3
    need(last3 < losses[0], f"{arch} training loss did not fall: first "
                            f"{losses[0]}, mean of the last 3 {last3}")
    need_counts(counts, {k: v * TRAIN28_STEPS for k, v in per_step.items()},
                f"{arch} training run")
    tokens = 8 * 512
    step_ms = sorted(tokens / t * 1e3 for t in hist["tps"][1:])
    med = step_ms[len(step_ms) // 2]
    opt = AdamW(lr=warmup_cosine(float(TRAIN28_LR), TRAIN28_STEPS // 10,
                                 TRAIN28_STEPS), weight_decay=0.01)
    batch = family_batches(cfg, dev, 8, 512, 1)[0]
    same, (wall, busy, per) = same_first_step(model, opt, batch,
                                              profile=True)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    scan_bwd = sum(ms for name, ms in per.items()
                   if "ssd_bwd" in name or "rglru_bwd" in name)
    print(f"  full-width {arch} ({cfg.n_layers} layers), {TRAIN28_STEPS} "
          f"steps of (8, 512) tokens: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (last 3 mean {last3:.4f}); step ms (steps "
          f"2-{TRAIN28_STEPS}) median {med:.1f}, min {step_ms[0]:.1f}, max "
          f"{step_ms[-1]:.1f}; {tokens / med * 1e3:,.0f} tokens/s; peak "
          f"memory {peak / 2**30:.2f} GiB; run {run_s:.1f} s; the first "
          f"step twice from the same init: "
          f"{'bit-equal' if same else 'DIFFERS'}; one step profiled: wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}), "
          f"of which the scan's backward kernels {scan_bwd:.1f} ms "
          f"({scan_bwd / busy:.1%}); the largest kernels "
          + "; ".join(f"{name[:48]} {ms:.1f}" for name, ms in top))
    need(same, f"{arch}: the training step is not deterministic")
    need(busy > 0, f"{arch} training step: the profiler saw no device time")
    return counts, {"step_ms": med, "tokens_per_s": tokens / med * 1e3,
                    "peak_bytes": peak, "busy": busy / wall,
                    "busy_ms": busy, "scan_bwd_ms": scan_bwd}


def other_family(dev, arch: str, layers, batch: int, seq: int,
                 steps: int) -> dict:
    """``steps`` donated ``make_train_step`` steps of ``arch`` (at full
    width, its depth cut to ``layers``, or its smoke config) on its
    family's batches: finite losses and exact launches a step; then the
    first step again from the same init, bit-equal.  Returns the run's
    launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.training.optim import AdamW, warmup_cosine
    cfg = get_config(arch, smoke=layers == "smoke")
    if isinstance(layers, int):
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = transformer.build(cfg, device=dev)
    opt = AdamW(lr=warmup_cosine(3e-3, 1, steps), weight_decay=0.01)
    batches = family_batches(cfg, dev, batch, seq, steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.registry.reset_counts()
    t0 = time.perf_counter()
    (loss0, dig0), step, p, s = first_step(model, opt, batches[0])
    losses = [float(loss0)]
    for b in batches[1:]:
        p, s, m = step(p, s, b)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.registry.dispatch_snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    del p, s
    torch.cuda.empty_cache()
    need(all(map(math.isfinite, losses)), f"{arch} losses {losses}")
    need_counts(counts, {k: v * steps for k, v in train_counts(model).items()},
                f"{arch} training")
    (loss1, dig1), _, p, s = first_step(model, opt, batches[0])
    del p, s
    torch.cuda.empty_cache()
    same = torch.equal(loss0, loss1) and torch.equal(dig0, dig1)
    print(f"  {arch} ({cfg.name}, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params), {steps} steps of "
          f"({batch}, {seq}): losses {' '.join(f'{l:.4f}' for l in losses)}"
          f"; {run_s:.1f} s; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{nonzero(counts)}; the first step twice "
          f"{'bit-equal' if same else 'DIFFERS'}")
    need(same, f"{arch}: the training step is not deterministic")
    return counts


def train_families(dev, report: dict) -> dict:
    """Phase 28: the scans' backward kernels against plain
    (:func:`check_scan_backwards`); the card against the CPU at f32 for
    the two recurrent families at small depth; full-width mamba2-780m and
    recurrentgemma-2b through ``launch/train.py``
    (:func:`full_width_run`); the MoE, audio and VLM families through
    ``make_train_step`` (:func:`other_family`).  Each run's launches are
    counted from 0 and summed into the path's.  Returns (the path's
    launches, each full-width run's numbers)."""
    import torch
    t0 = time.perf_counter()
    check_scan_backwards(dev, report)
    t1 = time.perf_counter()
    for arch, n_layers, batch, seq in TRAIN28_CPU:
        train_card_vs_cpu(dev, arch, n_layers, batch, seq)
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    path: dict = {}

    def add(counts):
        for k, v in counts.items():
            path[k] = path.get(k, 0) + v
    runs = {}
    for arch in TRAIN28_ARCHS:
        counts, runs[arch] = full_width_run(dev, arch)
        add(counts)
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    for spec in OTHER_FAMILIES:
        add(other_family(dev, *spec))
        torch.cuda.empty_cache()
    print(f"  phase 28: kernel checks {t1 - t0:.1f} s, card vs CPU "
          f"{t2 - t1:.1f} s, full-width runs {t3 - t2:.1f} s, the other "
          f"families {time.perf_counter() - t3:.1f} s")
    return {"launches": path, "runs": runs}



# ---------------------------------------------------------------------------
# phase 29: chunked prefill at full width
# ---------------------------------------------------------------------------

CHUNK = 2048                # LM.prefill_chunked's default
CHUNK_PROMPT = 8192         # (a)'s and (c)'s prompt rows
LONG_PROMPT = 32_768        # SHAPES["prefill_32k"]'s length, (b)'s
CHUNK_STEPS = 16            # greedy decode steps from each cache in (a)
CHUNK_VLM_IMG = 256         # internvl2's image rows ahead of the tokens
# (a)'s tolerances: tests/test_chunked_prefill.py:37-42 (prefill) and
# :60-62 (each decode step)
CHUNK_TOL = dict(atol=2e-4, rtol=1e-3)
STEP_TOL = dict(atol=1e-4, rtol=1e-3)
# the chunk-shape flash check: max |err| over max |plain|, bf16 output
# rounding is 2^-9 relative; q scaled so attention is peaked
FLASH_CHUNK_REL = 1e-2
FLASH_PEAK = 4.0


def check_flash_chunk(dev, g):
    """``flash_attention`` at the chunked prefill's last chunk of a
    32768-token prompt: queries at the last CHUNK of T = 32768 keys, k/v
    transposed views of a kv-major cache, smollm-360m's heads, bf16.
    Held against plain by ``rel_err`` (an N(0, 1) q averages over ~32k
    keys, so its outputs are ~0.01 and an absolute tolerance would pass a
    kernel that dropped the diagonal block), also with q scaled by
    FLASH_PEAK so each row's attention is peaked and its outputs O(1);
    the last CHUNK rows equal those of an S = T = CHUNK_PROMPT call bit for
    bit.  Then timed beside plain, its bound and SDPA with a bottom-right
    causal mask (k/v heads repeated, which SDPA's bottom-right path needs)
    into the kernel's ``more`` list."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import flash_attention as fmod
    S, T, H, K, dh = CHUNK, LONG_PROMPT, 15, 5, 64
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf16)
    q = randn(1, S, H, dh)
    kc, vc = randn(1, K, T, dh), randn(1, K, T, dh)          # kv-major
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    got = fmod.flash_attention(q, k, v, causal=True)
    want = fmod.plain(q, k, v, causal=True)
    qp = q * FLASH_PEAK
    err_p = rel_err(fmod.flash_attention(qp, k, v, causal=True),
                    fmod.plain(qp, k, v, causal=True))
    # the same rows as the last CHUNK of an unchunked call at T' = 8192
    T2 = CHUNK_PROMPT
    q2 = randn(1, T2, H, dh)
    k2, v2 = (c[:, :, :T2].transpose(1, 2) for c in (kc, vc))
    full = fmod.flash_attention(q2, k2, v2, causal=True)
    cont = fmod.flash_attention(q2[:, T2 - S:], k2, v2, causal=True)
    qt = q.transpose(1, 2)
    kt, vt = (c.repeat_interleave(H // K, dim=1) for c in (kc, vc))
    mask = causal_lower_right(S, T)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib = library().transpose(1, 2)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    lib_err = rel_err(lib, want)
    same = torch.equal(cont, full[:, T2 - S:])
    print(f"  flash_attention S={S} at T={T} (H={H} K={K} dh={dh}, "
          f"strided kv-major views) bf16: max abs err / max |plain| "
          f"{err:.3e}, with q x {FLASH_PEAK} (peaked) {err_p:.3e} (tol "
          f"{FLASH_CHUNK_REL}); SDPA with causal_lower_right {lib_err:.3e}; "
          f"the last {S} of T={T2} vs S=T={T2}: "
          f"{'bit-equal' if same else 'DIFFERS'}")
    need(all(math.isfinite(x) and x <= FLASH_CHUNK_REL for x in (err, err_p)),
         f"flash_attention at the chunk shape: rel err {err}, peaked {err_p}")
    need(same, f"flash_attention's last {S} rows at T={T2} depend on S")
    del full, cont, q2, qp
    del got, want, lib
    extra_line("flash_attention",
               f"bf16 q (1,{S},{H},{dh}) at the last {S} of T={T}, k/v "
               f"(1,{T},{K},{dh}) transposed views of a kv-major cache, "
               f"causal",
               lambda: fmod.flash_attention(q, k, v, causal=True),
               lambda: fmod.plain(q, k, v, causal=True), library,
               cost_bound("flash_attention", q, k, v, peak=bf16),
               library="SDPA, causal_lower_right, kv heads repeated")


def need_exact(got: dict, want: dict, what: str):
    """Every kernel's launches: ``want``'s, and none elsewhere."""
    need(nonzero(got) == nonzero(want),
         f"{what}: launches {nonzero(got)}, not {nonzero(want)}")


def prefill_run(model, params, batch, cache_len: int, chunk=None,
                repeats: int = 3) -> dict:
    """One prefill (``prefill_chunked`` when ``chunk`` is given) into a
    fresh cache: the last position's f32 logits, the cache and the run's
    launches, its ms on the host clock (ending in a synchronise), and its
    ``max_memory_allocated`` beside what was resident before it (params
    and cache); then the same prefill ``repeats`` times more into that
    cache, their median ms (the steady state: the allocator warm)."""
    import torch
    from repro_torch.kernels import ops
    B = next(iter(batch.values())).shape[0]
    cache = model.init_cache(B, cache_len)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if chunk:
            lg, _ = model.prefill_chunked(params, batch, cache, chunk=chunk)
        else:
            lg, _ = model.prefill(params, batch, cache)
        # a copy: a view would hold the whole logits alive (f32 ``.float()``
        # returns its input)
        last = lg[:, -1].to(torch.float32, copy=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return last, ms, torch.cuda.max_memory_allocated(), tuple(lg.shape)
    before = ops.registry.dispatch_snapshot()
    last, ms, peak, shape = run()
    out = {"last": last, "cache": cache, "counts": delta(before),
           "first_ms": ms, "peak": peak, "base": base, "shape": shape,
           "runs_ms": []}
    for _ in range(repeats):
        _, ms, peak, _ = run()
        out["runs_ms"].append(ms)
        out["peak"] = max(out["peak"], peak)
    out["ms"] = sorted(out["runs_ms"] or [ms])[len(out["runs_ms"]) // 2]
    return out


def close_report(a, b, tol: dict) -> tuple:
    """(within ``tol`` as ``allclose`` reads it, max |a - b|)."""
    d = (a.float() - b.float()).abs()
    ok = bool((d <= tol["atol"] + tol["rtol"] * b.float().abs()).all())
    return ok, d.max().item()


def chunked_equal(label: str, runs: dict) -> float:
    """Chunked against unchunked: the last position's logits and every
    cache leaf within CHUNK_TOL; prints the largest difference and
    whether all of them are bit-equal; returns the logits' difference."""
    import torch
    from repro_torch import tree as tree_util
    u, c = runs["unchunked"], runs["chunked"]
    ok, d = close_report(c["last"], u["last"], CHUNK_TOL)
    same = torch.equal(c["last"], u["last"])
    worst = 0.0
    for (path, a), b in zip(tree_util.leaves_with_path(c["cache"]),
                            tree_util.leaves(u["cache"])):
        ok_l, d_l = close_report(a, b, CHUNK_TOL)
        worst = max(worst, d_l)
        same = same and torch.equal(a, b)
        need(ok_l, f"{label} cache leaf {'/'.join(path)}: chunked vs "
                   f"unchunked max abs diff {d_l:.3e} beyond {CHUNK_TOL}")
    print(f"    {label}: last-position logits chunked vs unchunked max abs "
          f"diff {d:.3e}, every cache leaf {worst:.3e} (tol {CHUNK_TOL}); "
          f"{'all bit-equal' if same else 'not bit-equal'}")
    need(ok, f"{label} chunked logits {d:.3e} from unchunked, beyond "
             f"{CHUNK_TOL}")
    return d


def print_runs(label: str, runs: dict):
    for side, r in runs.items():
        times = ", ".join(f"{t:.1f}" for t in r["runs_ms"])
        print(f"    {label} {side}: logits {r['shape']}, {r['ms']:.1f} ms "
              f"(median of {times}; first run {r['first_ms']:.1f} ms; host "
              f"clock, synchronised), peak memory {r['peak'] / 2**30:.3f} GiB "
              f"({(r['peak'] - r['base']) / 2**30:.3f} GiB above the "
              f"{r['base'] / 2**30:.3f} GiB of params and cache before "
              f"it); launches {nonzero(r['counts'])}")


def chunk_counts(cfg, chunks: int) -> dict:
    """Launches of a uniform attention stack's prefill over ``chunks``
    chunks: flash and both norms a layer a chunk, the final norm once
    (the head runs on the last chunk only)."""
    fwd, _ = lm_counts(cfg)
    out = {"flash_attention": fwd["flash_attention"] * chunks}
    if "rmsnorm" in fwd:
        out["rmsnorm"] = (fwd["rmsnorm"] - 1) * chunks + 1
    return out


def chunked_vs_f32(label: str, cfg, dev, batch, params32, cache_len: int
                   ) -> dict:
    """(b) and (c): the bf16 prefill unchunked and chunked (CHUNK) on
    bf16 weights, and unchunked in f32 on the f32 weights: the
    last-position logits and every cache leaf chunked against unchunked
    within CHUNK_TOL (:func:`chunked_equal`, as in (a): both runs are the
    same kernels at one precision), the greedy next token equal, and the
    chunked run's last-position logits no further from the unchunked
    run's than 1.1 x the unchunked run's distance from the f32 run (phase
    6's rule: chunking may move the logits no more than bf16 does)."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.models import transformer
    S = sum(v.shape[1] for v in batch.values())
    m16 = transformer.build(cfg, device=dev)
    m32 = transformer.build(
        dataclasses.replace(cfg, compute_dtype=torch.float32), device=dev)
    params16 = tree_util.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        params32)
    runs = {"unchunked": prefill_run(m16, params16, batch, cache_len)}
    need_exact(runs["unchunked"]["counts"], chunk_counts(cfg, 1),
               f"{label} unchunked prefill")
    runs["chunked"] = prefill_run(m16, params16, batch, cache_len, CHUNK)
    need_exact(runs["chunked"]["counts"], chunk_counts(cfg, S // CHUNK),
               f"{label} chunked prefill")
    for side, r in runs.items():
        def again(side=side, cache=r["cache"]):
            if side == "chunked":
                return m16.prefill_chunked(params16, batch, cache,
                                           chunk=CHUNK)
            return m16.prefill(params16, batch, cache)
        wall, busy, per = device_busy(again, by_kernel=True)
        flash = sum(ms for name, ms in per.items() if "flash" in name)
        print(f"    {label} {side}, one run profiled: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms ({busy / wall:.1%}), of which "
              f"flash_attention {flash:.1f} ms")
    d_chunk = chunked_equal(label, runs)
    for r in runs.values():
        r["cache"] = None
    del params16
    t0 = time.perf_counter()
    f32 = prefill_run(m32, params32, batch, cache_len, repeats=0)
    f32_s = time.perf_counter() - t0
    need_exact(f32["counts"], chunk_counts(cfg, 1), f"{label} f32 prefill")
    u, c, o = runs["unchunked"]["last"], runs["chunked"]["last"], f32["last"]
    d_bf16 = (u - o).abs().max().item()
    scale = o.abs().max().item()
    tu, tc, to = (int(x[0].argmax()) for x in (u, c, o))
    print_runs(label, runs)
    print(f"    {label}: last position, chunked vs unchunked max abs diff "
          f"{d_chunk:.4e}; unchunked bf16 vs f32 {d_bf16:.4e} (limit "
          f"1.1 x; max |logit| {scale:.3f}); greedy next token chunked "
          f"{tc}, unchunked {tu}, f32 {to}; the f32 prefill took "
          f"{f32_s:.1f} s (host clock)")
    need(all(math.isfinite(x) for x in (d_chunk, d_bf16, scale)),
         f"{label}: logits not finite")
    need(d_chunk <= 1.1 * d_bf16,
         f"{label}: chunking moved the logits {d_chunk:.4e}, beyond 1.1 x "
         f"bf16's {d_bf16:.4e}")
    need(tc == tu, f"{label}: greedy next token {tc} chunked, {tu} "
                   f"unchunked")
    return {"runs": runs, "d_chunk": d_chunk, "d_bf16": d_bf16}


def chunked_prefill(dev) -> dict:
    """Phase 29: ``LM.prefill_chunked`` at full width on the card.
    (a) smollm-360m, f32, B 2, S CHUNK_PROMPT: chunked against unchunked
    prefill (last-position logits and every cache leaf), then CHUNK_STEPS
    greedy decode steps from each cache, tokens equal and each step's
    logits within STEP_TOL; (b) smollm-360m, bf16, B 1, S LONG_PROMPT and
    (c) internvl2-76b at INTERNVL_LAYERS layers, bf16, B 1, S
    CHUNK_PROMPT with CHUNK_VLM_IMG image rows: :func:`chunked_vs_f32`.
    Exact launches on every run; ms and peak memory chunked and
    unchunked.  The flash check at the chunk shape comes first and counts
    on no path."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    check_flash_chunk(dev, g)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ops.registry.reset_counts()

    # (a) smollm-360m, f32, B 2, S CHUNK_PROMPT
    cfg = get_config("smollm-360m")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    m32 = transformer.build(cfg32, device=dev)
    params32 = m32.init(0)
    B, S = 2, CHUNK_PROMPT
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g, device=dev)}
    runs = {"unchunked": prefill_run(m32, params32, batch, S + CHUNK_STEPS),
            "chunked": prefill_run(m32, params32, batch, S + CHUNK_STEPS,
                                   CHUNK)}
    need_exact(runs["unchunked"]["counts"], chunk_counts(cfg, 1),
               "(a) unchunked prefill")
    need_exact(runs["chunked"]["counts"], chunk_counts(cfg, S // CHUNK),
               "(a) chunked prefill")
    print_runs(f"(a) smollm-360m f32 B 2 S {S}", runs)
    chunked_equal("(a)", runs)
    toks = {k: r["last"].argmax(-1) for k, r in runs.items()}
    need(torch.equal(toks["chunked"], toks["unchunked"]),
         "(a) first greedy tokens differ")
    before = ops.registry.dispatch_snapshot()
    step_diff, seq = 0.0, [toks["chunked"].tolist()]
    t_dec = time.perf_counter()
    for t in range(S, S + CHUNK_STEPS):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        lg = {k: m32.decode_step(params32, runs[k]["cache"],
                                 toks[k][:, None], pos)[0][:, 0]
              for k in runs}
        ok, d = close_report(lg["chunked"], lg["unchunked"], STEP_TOL)
        step_diff = max(step_diff, d)
        need(ok, f"(a) decode step at {t}: logits {d:.3e} apart, beyond "
                 f"{STEP_TOL}")
        toks = {k: v.argmax(-1) for k, v in lg.items()}
        need(torch.equal(toks["chunked"], toks["unchunked"]),
             f"(a) greedy tokens differ at {t}")
        seq.append(toks["chunked"].tolist())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t_dec
    _, per_step = lm_counts(cfg)
    need_exact(delta(before), {k: v * CHUNK_STEPS * 2
                               for k, v in per_step.items()},
               "(a) decode steps")
    print(f"    (a): {CHUNK_STEPS} greedy decode steps from each cache in "
          f"{dec_s:.1f} s: tokens equal, each step's logits within "
          f"{step_diff:.3e} (tol {STEP_TOL}); row 0's tokens "
          f"{[s_[0] for s_ in seq]}")
    del runs, lg
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # (b) smollm-360m, bf16, B 1, S 32768
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                                     generator=g, device=dev)}
    b = chunked_vs_f32(f"(b) smollm-360m bf16 B 1 S {LONG_PROMPT}", cfg, dev,
                       batch, params32, LONG_PROMPT)
    del params32, m32
    torch.cuda.empty_cache()
    t3 = time.perf_counter()

    # (c) internvl2-76b at INTERNVL_LAYERS of 80 layers, bf16, B 1, S
    # CHUNK_PROMPT with CHUNK_VLM_IMG image rows
    cfg = dataclasses.replace(get_config("internvl2-76b"),
                              n_layers=INTERNVL_LAYERS)
    params32 = transformer.build(
        dataclasses.replace(cfg, compute_dtype=torch.float32),
        device=dev).init(0)
    S = CHUNK_PROMPT
    batch = {"img": torch.randn(1, CHUNK_VLM_IMG, cfg.frontend_dim,
                                generator=g, device=dev),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (1, S - CHUNK_VLM_IMG), generator=g,
                                     device=dev)}
    c = chunked_vs_f32(f"(c) internvl2-76b {INTERNVL_LAYERS} layers bf16 B 1 "
                       f"S {S} ({CHUNK_VLM_IMG} image rows)", cfg, dev,
                       batch, params32, S)
    del params32
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    print(f"  phase 29: flash check {t1 - t0:.1f} s, (a) {t2 - t1:.1f} s, "
          f"(b) {t3 - t2:.1f} s, (c) {t4 - t3:.1f} s")
    return {"launches": ops.registry.dispatch_snapshot(),
            "kernels": ("flash_attention", "decode_attention", "rmsnorm"),
            "b": b, "c": c}


# ---------------------------------------------------------------------------
# phase 30: the dry run against the card
# ---------------------------------------------------------------------------

# processes tracing the meta table, beside phase 32's mixtral deploy
# (which keeps a core or two of the 8 busy)
DRYRUN_WORKERS = 4
# the cells run for real: (arch, shape, batch as cut from the published)
DRYRUN_CARD = (("smollm-360m", "train_4k", 2),
               ("smollm-360m", "prefill_32k", 1),
               ("smollm-360m", "decode_32k", 8),
               ("mamba2-780m", "prefill_32k", 1),
               ("mamba2-780m", "long_500k", 1))
DRYRUN_TIMED = 3            # timed steps (after one to warm up), median
PEAK_RATIO = (0.5, 2.0)     # traced peak over the card's, accepted


def alloc_slack(nbytes: int) -> int:
    """The most the caching allocator's ``memory_allocated`` can count for
    one live storage of ``nbytes`` above its size: the request rounded up
    to 512 bytes, and a block whose rest it does not split off (under 512
    bytes in the small pool, storages up to 1 MiB; up to 1 MiB in the
    large pool)."""
    return 511 + (511 if nbytes <= 1 << 20 else 1 << 20)


def meta_table() -> tuple:
    """``launch/dryrun.py --all --both-meshes`` on meta tensors, in
    :data:`DRYRUN_WORKERS` processes, the train cells (the longest)
    first.  CPU work: :func:`mixtral_full` runs it beside its deploy
    (set-up, which waits on the card and on writes) and phase 30 reads
    it (:func:`dryrun_table`).  Returns (records, s)."""
    from repro_torch.launch import dryrun
    jobs = [(a, s, dict(multi_pod=mp, costs=not mp))
            for a, s in dryrun.iter_cells() for mp in (False, True)]
    jobs.sort(key=lambda j: j[1] != "train_4k")
    t0 = time.perf_counter()
    recs = list(dryrun.records(jobs, DRYRUN_WORKERS))
    return recs, time.perf_counter() - t0


def dryrun_table(table) -> list:
    """The meta table of :func:`meta_table`: every cell ok or
    skipped, the skips the 7 cells (x 2 meshes) the reference skips, with
    its reasons (``configs.supported``, held to the reference's by
    ``tests/test_torch_dryrun.py``)."""
    from repro_torch.configs import SHAPES, supported
    from repro_torch.launch import dryrun
    from repro_torch.models.api import get_config
    recs, secs = table
    for rec in recs:
        print("  " + dryrun.summary(rec))
    print(f"  the table: {len(recs)} records in {secs:.1f} s beside phase "
          f"32's mixtral deploy ({DRYRUN_WORKERS} workers, "
          f"{sum(r.get('trace_s', 0) for r in recs):.1f} s of traces)")
    bad = [f"{r['arch']} {r['shape']} {r['mesh']}: {r.get('error')}"
           for r in recs if r["status"] not in ("ok", "skip")]
    need(not bad, f"dry run cells failed: {bad}")
    skips = [r for r in recs if r["status"] == "skip"]
    need(len(skips) == 14 and all(
        r["skip_reason"] == supported(get_config(r["arch"]),
                                      SHAPES[r["shape"]])[1]
        for r in skips), f"dry run skips: {len(skips)}")
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "dryrun_table.json"), "w") as f:
        json.dump(recs, f, indent=1)
    return recs


def dryrun_on_card(dev, arch: str, shape: str, batch: int) -> dict:
    """One cell traced on meta, then the same step at full width and depth
    on the card inside the same counting context, with seed-0 weights made
    on the card: FLOPs, bytes, kernel calls and the state trees' bytes
    equal exactly, the bytes requested of the allocator while building
    the card's trees equal theirs exactly (its allocated delta within
    :func:`alloc_slack` of them), the kernel calls equal the launches, the
    traced peak within :data:`PEAK_RATIO` of the card's above the state;
    ms a step
    (median of :data:`DRYRUN_TIMED` after a warm-up) and its roofline."""
    import statistics
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch import cost_analysis, dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.api import get_config
    cfg, pub = get_config(arch), SHAPES[shape]
    cell = dataclasses.replace(pub, batch=batch)
    mesh = make_production_mesh()
    label = f"{arch} {shape}"
    print(f"  {label}: reduced: batch {pub.batch} -> {batch} (seq "
          f"{cell.seq}, all {cfg.n_layers} layers at full width)")
    t0 = time.perf_counter()
    cm = dryrun.build_cell(cfg, cell, mesh, device="meta")
    meta = cost_analysis.count_step(cm.step)
    meta_state = cm.state_bytes()
    del cm
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    r0 = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    cc = dryrun.build_cell(cfg, cell, mesh, device=dev, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    requested = torch.cuda.memory_stats(dev)["requested_bytes.all.current"] \
        - r0
    card_state = cc.state_bytes()
    slack = sum(alloc_slack(n) for t in (cc.params, cc.opt_state, cc.cache,
                                         cc.batch)
                for n in cost_analysis.storage_sizes(t))
    before = ops.registry.dispatch_snapshot()
    torch.cuda.reset_peak_memory_stats(dev)
    with cost_analysis.counting() as tally:
        out = cc.step()
        del out
        torch.cuda.synchronize()
    card = tally.record()
    after = ops.registry.dispatch_snapshot()
    launched = {n: after[n] - before[n] for n in after
                if after[n] != before[n]}
    peak = torch.cuda.max_memory_allocated(dev) - base
    t2 = time.perf_counter()
    cc.step()
    torch.cuda.synchronize()
    times = []
    for _ in range(DRYRUN_TIMED):
        t = time.perf_counter()
        out = cc.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        del out
    ms = statistics.median(times)
    last = ops.registry.dispatch_snapshot()
    t3 = time.perf_counter()
    del cc
    torch.cuda.empty_cache()

    state = sum(card_state.values())
    ratio = meta["peak_live_bytes"] / max(peak, 1)
    terms = roofline.terms(card["flops"], card["bytes"])
    bound_ms = terms["bound_s"] * 1e3
    mf = roofline.model_flops(arch, shape, batch=batch)
    share = mf / (ms / 1e3 * roofline.PEAK_FLOPS)
    print(f"    meta: {meta['flops']:.6e} FLOPs, {meta['bytes']:.6e} bytes, "
          f"kernels {meta['kernels']} (traced in {t1 - t0:.1f} s)")
    print(f"    card: {card['flops']:.6e} FLOPs, {card['bytes']:.6e} bytes, "
          f"kernels {card['kernels']}, launched {launched}")
    print(f"    state bytes {card_state} = {state} (meta {meta_state}); "
          f"requested of the allocator while building {requested}; its "
          f"allocated delta {base - m0} ({(base - m0) / max(state, 1):.6f} of "
          f"the state, its rounding at most {slack} above it)")
    print(f"    peak above the state: traced {meta['peak_live_bytes']} "
          f"(card's tally {card['peak_live_bytes']}), "
          f"max_memory_allocated {peak}: ratio {ratio:.4f}")
    print(f"    ms a step {ms:.3f} (runs {', '.join(f'{t:.3f}' for t in times)}"
          f"; counted run and timing {t3 - t1:.1f} s)")
    print(f"    roofline: t_compute {terms['t_compute_s'] * 1e3:.4f} ms, "
          f"t_memory {terms['t_memory_s'] * 1e3:.4f} ms, {terms['dominant']}"
          f"-bound, the step {ms / bound_ms:.2f}x its bound; model FLOPs "
          f"{mf:.6e}, share of 989 TFLOP/s {share:.6f}")
    for key in ("flops", "bytes", "kernels"):
        need(meta[key] == card[key], f"{label}: {key} meta {meta[key]} "
             f"against card {card[key]}")
    need(card["kernels"] == launched, f"{label}: kernel calls "
         f"{card['kernels']} against launches {launched}")
    need(card_state == meta_state, f"{label}: state bytes {card_state} "
         f"against meta {meta_state}")
    need(requested == state, f"{label}: {requested} bytes requested of the "
         f"allocator while building, not the state's {state}")
    need(state <= base - m0 <= state + slack, f"{label}: the allocator's "
         f"delta {base - m0} outside [{state}, {state + slack}]")
    need(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
         f"{label}: traced peak / card peak {ratio:.4f} outside "
         f"{PEAK_RATIO}")
    return {"label": label, "ms": ms, "runs": times, "flops": card["flops"],
            "bytes": card["bytes"], "kernels": card["kernels"],
            "state_bytes": state, "requested": requested,
            "allocated": base - m0, "peak": peak,
            "traced_peak": meta["peak_live_bytes"], "ratio": ratio,
            "model_flops": mf, "share": share, "bound_ms": bound_ms,
            "terms": terms, "launches": {n: last[n] - before[n]
                                         for n in last}}


def dryrun_phase(dev, table) -> dict:
    """Phase 30: the meta table (``table``, :func:`meta_table`'s), then
    :data:`DRYRUN_CARD` on the card."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    dryrun_table(table)
    t1 = time.perf_counter()
    cells = [dryrun_on_card(dev, *c) for c in DRYRUN_CARD]
    launches = {n: sum(c["launches"][n] for c in cells)
                for n in ops.registry.names()}
    print(f"  phase 30: the meta table {t1 - t0:.1f} s, the cells on the "
          f"card {time.perf_counter() - t1:.1f} s")
    return {"cells": cells, "launches": launches,
            "kernels": ("flash_attention", "flash_attention_bwd",
                        "decode_attention", "ssd_scan", "rmsnorm",
                        "rmsnorm_bwd")}


# ---------------------------------------------------------------------------
# phase 31: the dense configs at full width (their depth cut for phase 32)
# ---------------------------------------------------------------------------

# (arch, the layers of full width phase 31 runs (cut from their full
# depth, 48, 32 and 24, to pay for phase 32), those the card runs against
# the CPU)
DENSE_FULL = (("yi-9b", 2, 2), ("codeqwen1.5-7b", 2, 2),
              ("h2o-danube-3-4b", 2, 2))
# the request past a sliding window (h2o-danube-3-4b's 4096 tokens): its
# prompt and its greedy tokens
WINDOW_PROMPT, WINDOW_NEW = 5120, 64
# the windowed forward against the decode steps, of max |logit|: between
# the sound ring's reading, 1.9e-5 on an H100, and the controls', 0.14
# and 0.16 (a window one key long and one key short)
WINDOW_TOL = 2e-3
# the controls: the forward with a window one key short and one key long
WINDOW_CONTROLS = (-1, 1)


def window_against_forward(model32, p32, prompt, cache_len: int):
    """The ring against the window, in f32, on ``p32`` (the int8 store
    loaded with f32 at A): ``reference_generate``'s greedy tokens past the
    window (each step's logits recorded as it runs), then one ``forward``
    over the prompt and those tokens (flash attention with the window): at
    every generated position its logits agree with the decode step's
    within :data:`WINDOW_TOL` of max |logit|, and its argmax is the step's
    token but at a near-tie.  The same forward with a window one key short
    and one key long (:data:`WINDOW_CONTROLS`) must differ from the decode
    steps by more than the limit, so that the limit tells a ring that keeps
    one key too few or too many.  A check: it runs outside the path's
    count."""
    import numpy as np
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import reference_generate
    rec = []
    real = {"prefill": model32.prefill, "decode_step": model32.decode_step}

    def recording(kind):
        def call(*a, **kw):
            lg, cache = real[kind](*a, **kw)
            rec.append(lg[0, -1].float())
            return lg, cache
        return call

    for kind in real:
        setattr(model32, kind, recording(kind))
    try:
        t0 = time.perf_counter()
        toks = reference_generate(model32, p32, prompt, n_new=WINDOW_NEW,
                                  cache_len=cache_len)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    finally:
        for kind in real:
            delattr(model32, kind)
    S, W = len(prompt), model32.cfg.sliding_window
    seq = torch.as_tensor(np.concatenate([prompt, toks]),
                          device=model32.device)[None]
    steps = torch.stack(rec)

    def against_steps(model):
        lg, _ = model.forward(p32, {"tokens": seq})
        return lg[0, S - 1:S - 1 + len(toks)].float()

    t0 = time.perf_counter()
    fwd = against_steps(model32)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    scale = fwd.abs().max().item()
    diff = (fwd - steps).abs().max().item()
    control = {W + d: (against_steps(transformer.build(
        dataclasses.replace(model32.cfg, sliding_window=W + d),
        device=model32.device)) - steps).abs().max().item()
        for d in WINDOW_CONTROLS}
    top = torch.topk(fwd, 2, dim=-1)
    margin = (top.values[:, 0] - top.values[:, 1]).tolist()
    arg = top.indices[:, 0].tolist()
    differ = [i for i, t in enumerate(toks) if arg[i] != t]
    ties = [i for i in differ if margin[i] <= WINDOW_TOL * scale]
    print(f"  window check, f32: {len(toks)} greedy tokens from a {S}-token "
          f"prompt ({S - W} past the {W}-token window, a "
          f"{min(cache_len, W)}-slot ring) in {gen_s:.1f} s; forward over "
          f"{seq.shape[1]} positions in {fwd_s:.1f} s (host clock); logits "
          f"at the {len(toks)} generated positions max abs diff {diff:.3e} "
          f"({diff / scale:.3e} of max |logit| {scale:.3f}, limit "
          f"{WINDOW_TOL}); the forward with window "
          + ", ".join(f"{w}: {c:.3e} ({c / scale:.3e})"
                      for w, c in control.items())
          + f"; argmax differs at {differ} (near-ties {ties})")
    need(len(rec) == len(toks) == WINDOW_NEW,
         f"window check: {len(rec)} steps recorded for {len(toks)} tokens")
    need(diff <= WINDOW_TOL * scale,
         f"window check: the windowed forward differs from the decode "
         f"steps by {diff:.3e} (max |logit| {scale:.3f})")
    for w, c in control.items():
        need(c > WINDOW_TOL * scale,
             f"window check: the forward with window {w} is within the "
             f"limit of the decode steps ({c:.3e}, max |logit| "
             f"{scale:.3f}): the limit does not tell a wrong window")
    need(differ == ties, f"window check: argmax differs from the decode "
         f"step's token away from a near-tie at "
         f"{sorted(set(differ) - set(ties))}")


def dense_family(dev, workdir: str, arch: str, layers: int,
                 cpu_layers: int) -> dict:
    """Phase 31 for one dense config at full width and ``layers`` of its
    depth: an int8
    store deployed one unit at a time from card-drawn weights (the peak
    of the process's resident memory bounded); the cicada cold start with
    bf16 at A and the int8-resident one (``7 L + 1`` ``quant_matmul`` a
    forward), held as phase 6 holds smollm to the f32 oracle, a load of
    the same store with f32 at A (the window check reuses it); 32 greedy
    tokens on the int8-resident params, and the slotted scheduler there
    (a sliding window's model adds a request past its window) and the
    paged one, with exact launches, tokens equal to
    ``reference_generate``'s and paged equal to slotted; a window's ring
    held to the windowed forward in f32; the card's memory returned; then
    ``cpu_layers`` layers of full width on the card against the CPU.
    Returns its path's launch counts
    (zeroed before the loads, read after the schedulers) and the kernels
    it must have launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import GenerateSpec, reference_generate

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = transformer.build(cfg)
    name = f"{arch}-int8"
    store = deploy_int8(model, workdir, name)
    check_card_quantization(model, store, name, "block_000")
    floor_ms = store.model_nbytes(name) / 2000e3
    n_q, n_other = leaf_counts(store, name)
    per_fwd, per_step = kernel_counts(cfg)
    fwd_q, step_q = kernel_counts(cfg, quant=True)
    fwd_qp, step_qp = kernel_counts(cfg, quant=True, paged=True)
    print(f"  kernels per forward {per_fwd}, per decode step {per_step}; "
          f"int8-resident per forward {fwd_q}, per slotted step {step_q}, "
          f"per paged step {step_qp}; bf16 at A: weight_transform "
          f"{n_q + n_other} per load ({n_q} int8 leaves, {n_other} f32 "
          f"leaves cast)")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    prompts = [prompt[0][:n] for n in (37, 64, 100, 128)]
    extra, cache_len = (), 256
    if cfg.sliding_window:
        long = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                 (WINDOW_PROMPT,))
        extra = (GenerateSpec(prompt=long, n_new=WINDOW_NEW),)
        cache_len = max(cache_len, WINDOW_PROMPT + WINDOW_NEW)
    mem0 = settled_memory()

    ops.registry.reset_counts()
    cast = cicada_load(model, store, name, batch, "cicada, bf16 at A",
                       apply_dtype=torch.bfloat16)
    need_counts(cast["load"], {**per_fwd, "weight_transform": n_q + n_other,
                               "quant_matmul": 0}, f"{arch} bf16-at-A load")
    need_counts(cast["forward"], {**per_fwd, "quant_matmul": 0},
                f"{arch} bf16 warm forward")
    quant = cicada_load(model, store, name, batch,
                        "cicada, int8-resident (compute_quant)",
                        compute_quant=True)
    need_counts(quant["load"], fwd_q, f"{arch} int8-resident load")
    need_counts(quant["forward"], fwd_q, f"{arch} int8-resident warm forward")
    pb, pq = cast["res"].params, quant["res"].params
    print(f"  loads against the I/O floor {floor_ms:.0f} ms: bf16 at A "
          f"{cast['res'].trace.total_time() * 1e3 / floor_ms:.2f}x, "
          f"int8-resident "
          f"{quant['res'].trace.total_time() * 1e3 / floor_ms:.2f}x; "
          f"resident params bf16 {param_bytes(pb) / 1e9:.3f} GB, "
          f"int8-resident {param_bytes(pq) / 1e9:.3f} GB")
    deq = cast["res"].logits.float()       # the oracle rule's floor
    del cast, pb
    before = ops.registry.dispatch_snapshot()
    t0 = time.perf_counter()
    toks = reference_generate(model, pq, prompt[0], n_new=32)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    need_counts(delta(before), {k: fwd_q.get(k, 0) + 31 * step_q.get(
        k, 0) for k in set(fwd_q) | set(step_q)},
                f"{arch} reference_generate")
    need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
         f"{arch}: bad tokens {toks}")
    print(f"  reference_generate, int8-resident, prompt 128: 32 greedy "
          f"tokens in {gen_ms:.1f} ms (host clock, prefill + 31 decode "
          f"steps): {toks}")
    runs = {pages: run_scheduler(
        model, pq, prompts, quant["first"],
        fwd_q if pages is None else fwd_qp,
        step_q if pages is None else step_qp,
        f"{arch} int8-resident {'slotted' if pages is None else 'paged'}",
        pages=pages, extra=extra if pages is None else (),
        cache_len=cache_len) for pages in (None, 16)}
    path = ops.registry.dispatch_snapshot()
    kernels = tuple(sorted({"weight_transform"}.union(*(
        nonzero(d) for d in (per_fwd, per_step, fwd_q, step_q, step_qp)))))

    check_tokens(f"{arch} int8-resident slotted", prompts,
                 runs[None]["tokens"][:4],
                 [toks if len(p) == 128 else
                  reference_generate(model, pq, p, n_new=32)
                  for p in prompts])
    check_tokens(f"{arch} int8-resident paged", prompts, runs[16]["tokens"],
                 runs[None]["tokens"][:4], "the slotted run's")
    for spec, got in zip(extra, runs[None]["tokens"][4:]):
        want = reference_generate(model, pq, spec.prompt, n_new=spec.n_new,
                                  cache_len=cache_len)
        print(f"  {arch} int8-resident slotted prompt {len(spec.prompt)}: "
              f"{'equal to' if got == want else 'DIFFERS from'} "
              f"reference_generate: {got}")
        need(len(got) == spec.n_new and got == want,
             f"{arch} prompt {len(spec.prompt)} differs from "
             f"reference_generate at token {first_diff(want, got)}")
    logits_q, first_q = quant["res"].logits.float(), quant["first"][0]
    del quant, pq, runs
    torch.cuda.empty_cache()
    model32 = transformer.build(dataclasses.replace(
        cfg, compute_dtype=torch.float32))
    f32 = cicada_load(model32, store, name, batch,
                      "cicada, f32 at A (the f32 oracle)")
    hold_to_oracle(f"{arch} int8-resident", logits_q, deq,
                   f32["res"].logits.float(), first_q)
    del deq, logits_q
    if extra:
        window_against_forward(model32, f32["res"].params, long, cache_len)
    del model32, f32
    shutil.rmtree(store.root)
    mem1 = settled_memory()
    print(f"  memory_allocated {mem1 / 1e6:.1f} MB after the model against "
          f"{mem0 / 1e6:.1f} MB before its loads; store removed")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"{arch}: {(mem1 - mem0) / 1e6:.1f} MB not returned")
    torch.cuda.empty_cache()
    card_vs_cpu_arch(dev, workdir, arch, layers=cpu_layers)
    return {arch: (path, kernels)}


def dense_configs(dev, workdir: str) -> dict:
    """Phase 31: :func:`dense_family` for each of :data:`DENSE_FULL`, one
    after another.  Returns each model's path."""
    paths = {}
    for arch, layers, cpu_layers in DENSE_FULL:
        t0 = time.perf_counter()
        paths.update(dense_family(dev, workdir, arch, layers, cpu_layers))
        print(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 32: the MoE configs at full size
# ---------------------------------------------------------------------------

# mixtral-8x7b's request past its 4096-token window: prompt, greedy tokens
MIXTRAL_LONG_PROMPT, MIXTRAL_LONG_NEW = 5120, 32
# the greedy tokens of each of the four scheduler requests of phase 32's
# models (a 32-layer int8-resident mixtral step takes about 0.3 s on the
# host)
MOE_NEW = 8
# arctic-480b's chunked prefill: the last chunk's logits against the
# unchunked run's at the tokens whose keep pattern both runs share, of
# max |logit| (f32)
ARCTIC_CHUNK_REL = 1e-4


def free_disk_after(workdir: str, free0: int, what: str):
    """``workdir``'s file system back to within 1 GB of ``free0`` free
    once a store is removed."""
    disk_free(workdir, f"after {what}'s store was removed")
    free1 = shutil.disk_usage(workdir).free
    need(free1 >= free0 - (1 << 30),
         f"{what}: {(free0 - free1) / 1e9:.1f} GB of disk not returned")


def mixtral_full(dev, workdir: str) -> tuple:
    """Phase 32, mixtral-8x7b at full width and its 32 layers (46.7 B
    params), int8-resident (the one residency that fits the card): an int8
    store deployed a unit at a time from card-drawn weights; the cicada
    cold start with ``compute_quant`` (launches: ``lm_counts`` plus
    ``quant_products``, phase 20's formula); 32 greedy tokens; the slotted
    scheduler (4 requests of 37-128 tokens, MOE_NEW tokens each, and
    one of 5120, 1024 past the window, 32 tokens) and the paged one,
    tokens equal ``reference_generate``'s with exact launches; the
    logits held to the streamed f32 oracle within 1.1x the streamed
    bf16's distance, and each block from the f32 forward's input
    (:func:`hold_layers`); one decode step's costs at occupancy 4 beside
    its byte floor; memory and disk returned.  Phase 30's meta table
    (:func:`meta_table`) runs beside the deploy.  Returns (the path, the
    table)."""
    import concurrent.futures

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import GenerateSpec, reference_generate

    cfg = get_config("mixtral-8x7b")
    model = transformer.build(cfg)
    name = "mixtral-8x7b-int8"
    free0 = shutil.disk_usage(workdir).free
    # phase 30's meta table beside the deploy only: set-up, whose seconds
    # no later phase reads; the load, the steps and their costs run alone
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        meta = pool.submit(meta_table)
        store = deploy_int8(model, workdir, name)
        t0 = time.perf_counter()
        table = meta.result()
    print(f"  phase 30's meta table ran beside the deploy (its seconds are "
          f"set-up, measured beside it); {time.perf_counter() - t0:.1f} s "
          f"waited for the table after the deploy")
    floor_ms = store.model_nbytes(name) / 2000e3
    per_fwd, per_step = lm_counts(cfg)
    fwd_q, step_q = kernel_counts(cfg, quant=True)
    fwd_qp, step_qp = kernel_counts(cfg, quant=True, paged=True)
    formula = {"quant_matmul": quant_products(cfg), "weight_transform": 0}
    need(fwd_q == {**per_fwd, **formula} and
         step_q == {**per_step, **formula} and step_qp == {
             **step_q, "decode_attention_paged": 0},
         f"mixtral: kernel_counts {fwd_q}, {step_q}, {step_qp} against "
         f"lm_counts + quant_products")
    print(f"  int8-resident: per forward {fwd_q}, per slotted step "
          f"{step_q}, per paged step {step_qp} (the 4096-token rings stay "
          f"slot-resident)")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    prompts = [prompt[0][:n] for n in (37, 64, 100, 128)]
    long = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (MIXTRAL_LONG_PROMPT,))
    extra = (GenerateSpec(prompt=long, n_new=MIXTRAL_LONG_NEW),)
    cache_len = MIXTRAL_LONG_PROMPT + MIXTRAL_LONG_NEW
    mem0 = settled_memory()

    ops.registry.reset_counts()
    quant = cicada_load(model, store, name, batch,
                        "cicada, int8-resident (compute_quant)",
                        compute_quant=True)
    need_counts(quant["load"], fwd_q, "mixtral int8-resident load")
    need_counts(quant["forward"], fwd_q, "mixtral int8-resident warm forward")
    pq = quant["res"].params
    # the warm-up's and the units' freed blocks out of PyTorch's cache: a
    # scheduler thread's cuBLAS handle allocates outside it
    torch.cuda.empty_cache()
    print(f"  load against the I/O floor {floor_ms:.0f} ms: "
          f"{quant['res'].trace.total_time() * 1e3 / floor_ms:.2f}x; "
          f"resident params {param_bytes(pq) / 1e9:.3f} GB")
    before = ops.registry.dispatch_snapshot()
    t0 = time.perf_counter()
    toks = reference_generate(model, pq, prompt[0], n_new=32)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    need_counts(delta(before), {k: fwd_q.get(k, 0) + 31 * step_q.get(k, 0)
                                for k in set(fwd_q) | set(step_q)},
                "mixtral reference_generate")
    need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
         f"mixtral: bad tokens {toks}")
    print(f"  reference_generate, int8-resident, prompt 128: 32 greedy "
          f"tokens in {gen_ms:.1f} ms (host clock, prefill + 31 decode "
          f"steps): {toks}")
    runs = {pages: run_scheduler(
        model, pq, prompts, quant["first"],
        fwd_q if pages is None else fwd_qp,
        step_q if pages is None else step_qp,
        f"mixtral-8x7b int8-resident "
        f"{'slotted' if pages is None else 'paged'}",
        pages=pages, extra=extra if pages is None else (),
        cache_len=cache_len, n_new=MOE_NEW) for pages in (None, 16)}
    path = ops.registry.dispatch_snapshot()

    # greedy: the first MOE_NEW of the 128-token prompt's 32 tokens
    check_tokens("mixtral-8x7b int8-resident slotted", prompts,
                 runs[None]["tokens"][:4],
                 [toks[:MOE_NEW] if len(p) == 128 else
                  reference_generate(model, pq, p, n_new=MOE_NEW)
                  for p in prompts], n=MOE_NEW)
    check_tokens("mixtral-8x7b int8-resident paged", prompts,
                 runs[16]["tokens"], runs[None]["tokens"][:4],
                 "the slotted run's", n=MOE_NEW)
    got = runs[None]["tokens"][4]
    want = reference_generate(model, pq, long, n_new=MIXTRAL_LONG_NEW,
                              cache_len=cache_len)
    print(f"  mixtral-8x7b int8-resident slotted prompt {len(long)} "
          f"({len(long) - cfg.sliding_window} past the window): "
          f"{'equal to' if got == want else 'DIFFERS from'} "
          f"reference_generate: {got}")
    need(len(got) == MIXTRAL_LONG_NEW and got == want,
         f"mixtral prompt {len(long)} differs from reference_generate at "
         f"token {first_diff(want, got)}")
    forced = []
    streamed = streamed_logits(model, pq, batch, forced=forced)
    # at 32 layers the whole-forward rule cannot tell a faulty path: the
    # streamed bf16 logits sit about as far from the f32 ones as
    # unrelated logits would (expert choices flip and compound), so each
    # block is also held from the f32 forward's own input
    hold_to_oracle("mixtral-8x7b int8-resident",
                   quant["res"].logits.float(),
                   streamed[torch.bfloat16].float(),
                   streamed[torch.float32].float(), quant["first"][0],
                   deq_label="streamed bf16")
    hold_layers("mixtral-8x7b int8-resident", forced)
    del streamed
    mixtral_costs(model, {"int8-resident": pq},
                  floor_ms=param_bytes(pq) / HBM_BPS * 1e3)
    del quant, pq, runs
    shutil.rmtree(store.root)
    mem1 = settled_memory()
    print(f"  memory_allocated {mem1 / 1e6:.1f} MB after the model against "
          f"{mem0 / 1e6:.1f} MB before its load; store removed")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"mixtral: {(mem1 - mem0) / 1e6:.1f} MB not returned")
    free_disk_after(workdir, free0, name)
    return {"mixtral-8x7b (32 layers)": (
        path, ("flash_attention", "decode_attention", "quant_matmul",
               "rmsnorm"))}, table


def arctic_layer(dev, workdir: str) -> dict:
    """Phase 32, one arctic-480b layer at full width (embed, block_000,
    final: 14.07 B params, 128 experts and the dense residual): an int8
    store drawn on the card, its block held to the host's quantization
    and its (128, 7168, 4864) expert leaf transformed against plain;
    cicada with bf16 at A, int8-resident and f32 at A (the oracle, loaded
    alone), exact launches, the int8-resident logits within 1.1x the
    bf16-at-A load's distance from it; 32 greedy tokens and both
    schedulers (16-token pages, prefix reuse: :func:`prefix_paged`) on
    the int8-resident params, tokens equal ``reference_generate``'s, and
    one step's costs at occupancy 4 beside its byte floor; then the
    chunked prefill on the f32 params (:func:`arctic_chunked`); memory and
    disk returned."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving import reference_generate

    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=1)
    model = transformer.build(cfg)
    name = "arctic-480b-int8"
    free0 = shutil.disk_usage(workdir).free
    store = deploy_int8(model, workdir, name)
    # the host's quantization of 13.6 G values took about a minute: its
    # expert leaves wu and wd take the path of wg
    check_card_quantization(model, store, name, "block_000",
                            skip=("moe/experts/wu", "moe/experts/wd"))
    check_expert_transform(store, name, "block_000", "moe/experts/wg",
                           timed=False)
    floor_ms = store.model_nbytes(name) / 2000e3
    n_q, n_other = leaf_counts(store, name)
    per_fwd, per_step = kernel_counts(cfg)
    fwd_q, step_q = kernel_counts(cfg, quant=True)
    fwd_qp, step_qp = kernel_counts(cfg, quant=True, paged=True)
    print(f"  kernels per forward {per_fwd}, per decode step {per_step}; "
          f"int8-resident per forward {fwd_q}, per slotted step {step_q}, "
          f"per paged step {step_qp}; bf16 at A: weight_transform "
          f"{n_q + n_other} per load ({n_q} int8 leaves, {n_other} f32 "
          f"leaves cast)")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 128))
    batch = {"tokens": torch.as_tensor(prompt)}
    prompts = [prompt[0][:n] for n in (37, 64, 100, 128)]
    mem0 = settled_memory()

    ops.registry.reset_counts()
    cast = cicada_load(model, store, name, batch, "cicada, bf16 at A",
                       apply_dtype=torch.bfloat16)
    need_counts(cast["load"], {**per_fwd, "weight_transform": n_q + n_other,
                               "quant_matmul": 0}, "arctic bf16-at-A load")
    need_counts(cast["forward"], {**per_fwd, "quant_matmul": 0},
                "arctic bf16 warm forward")
    work_a = (cast["res"].trace.summary()["work_A"],
              cast["load"]["weight_transform"])
    load_ms = {"bf16 at A": cast["res"].trace.total_time() * 1e3}
    deq = cast["res"].logits.float()
    del cast
    torch.cuda.empty_cache()
    quant = cicada_load(model, store, name, batch,
                        "cicada, int8-resident (compute_quant)",
                        compute_quant=True)
    need_counts(quant["load"], fwd_q, "arctic int8-resident load")
    need_counts(quant["forward"], fwd_q, "arctic int8-resident warm forward")
    torch.cuda.empty_cache()
    load_ms["int8-resident"] = quant["res"].trace.total_time() * 1e3
    pq = quant["res"].params
    before = ops.registry.dispatch_snapshot()
    t0 = time.perf_counter()
    toks = reference_generate(model, pq, prompt[0], n_new=32)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    need_counts(delta(before), {k: fwd_q.get(k, 0) + 31 * step_q.get(k, 0)
                                for k in set(fwd_q) | set(step_q)},
                "arctic reference_generate")
    need(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
         f"arctic: bad tokens {toks}")
    print(f"  reference_generate, int8-resident, prompt 128: 32 greedy "
          f"tokens in {gen_ms:.1f} ms (host clock, prefill + 31 decode "
          f"steps): {toks}")
    slotted = run_scheduler(model, pq, prompts, quant["first"], fwd_q,
                            step_q, "arctic-480b int8-resident slotted",
                            n_new=MOE_NEW)
    need(model.paged_kinds() == ["moe"] and model.supports_prefix_cache,
         "arctic does not page its KV")
    label = "arctic-480b int8-resident paged"
    paged = prefix_paged(model, pq, prompts, fwd_qp, step_qp, label)
    path = ops.registry.dispatch_snapshot()
    transform_share(store, name, torch.bfloat16, *work_a)
    refs = [toks[:MOE_NEW] if len(p) == 128 else
            reference_generate(model, pq, p, n_new=MOE_NEW)
            for p in prompts]
    check_tokens("arctic-480b int8-resident slotted", prompts,
                 slotted["tokens"], refs, n=MOE_NEW)
    check_prefix_tokens(model, pq, prompts, paged, refs, label)
    mixtral_costs(model, {"int8-resident": pq},
                  floor_ms=param_bytes(pq) / HBM_BPS * 1e3)
    logits_q, first_q = quant["res"].logits.float(), quant["first"][0]
    del quant, pq, slotted
    torch.cuda.empty_cache()
    model32 = transformer.build(dataclasses.replace(
        cfg, compute_dtype=torch.float32))
    f32 = cicada_load(model32, store, name, batch,
                      "cicada, f32 at A (the f32 oracle)")
    load_ms["f32 at A"] = f32["res"].trace.total_time() * 1e3
    print("  loads against the I/O floor "
          f"{floor_ms:.0f} ms: " + ", ".join(
              f"{k} {v:.1f} ms ({v / floor_ms:.2f}x)"
              for k, v in load_ms.items())
          + f"; f32 resident params "
          f"{param_bytes(f32['res'].params) / 1e9:.3f} GB")
    hold_to_oracle("arctic-480b int8-resident", logits_q, deq,
                   f32["res"].logits.float(), first_q)
    del deq, logits_q
    params32 = f32["res"].params
    del f32
    chunked = arctic_chunked(model32, params32)
    del params32
    shutil.rmtree(store.root)
    mem1 = settled_memory()
    print(f"  memory_allocated {mem1 / 1e6:.1f} MB after the model against "
          f"{mem0 / 1e6:.1f} MB before its loads; store removed")
    need(mem1 <= mem0 + PLATFORM_MEM_MARGIN,
         f"arctic: {(mem1 - mem0) / 1e6:.1f} MB not returned")
    free_disk_after(workdir, free0, name)
    return {"arctic-480b (1 layer)": (
        path, ("flash_attention", "decode_attention",
               "decode_attention_paged", "quant_matmul", "weight_transform",
               "rmsnorm")),
        "arctic-480b chunked prefill": (
            chunked, ("flash_attention", "rmsnorm"))}


def segmented_generate(model, params, prompt, off: int, n_new: int,
                       cache_len: int = 256) -> list:
    """``reference_generate`` (greedy, B 1, slotted) with the prompt's
    prefill split where a paged request that reuses ``off`` tokens of
    prefix pages splits it: ``prefill`` of ``prompt[:off]``, then
    ``prefill_continue`` of the rest, then ``decode_step``s."""
    import torch
    from repro_torch.serving.decode import (GenerateSpec, sample_first,
                                            sample_tokens)
    dev = model.device
    tok = torch.as_tensor(prompt, device=dev)[None]
    S = tok.shape[1]
    cache = model.init_cache(1, cache_len)
    model.prefill(params, {"tokens": tok[:, :off]}, cache)
    logits, cache = model.prefill_continue(params, {"tokens": tok[:, off:]},
                                           cache, off=off)
    out = [sample_first(logits, GenerateSpec(prompt=prompt, n_new=n_new), S)]
    zero = torch.zeros(1, device=dev)
    for t in range(S, S + n_new - 1):
        pos = torch.tensor([t], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, torch.tensor(
            [[out[-1]]], dtype=torch.int64, device=dev), pos)
        out.append(int(sample_tokens(logits[:, -1, :], zero.long(), pos + 1,
                                     zero)[0]))
    return out


# the paged scheduler's page size in phase 32's prefix reuse
PREFIX_PAGE = 16


def prefix_paged(model, params, prompts, per_fwd, per_step,
                 label: str) -> list:
    """The paged scheduler with prefix reuse, phase 22's pattern at full
    width, MOE_NEW tokens a request: the longest prompt alone first
    (nothing to reuse), then the others at once, each reusing the lead's
    pages of its prefix (``(n -
    1) // PREFIX_PAGE`` of them: a hit leaves a suffix to prefill), with
    exact launches, every hit counted, no page pinned.  Returns each
    request's tokens in ``prompts``' order (:func:`check_prefix_tokens`
    holds them)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeScheduler, GenerateSpec
    pt = PREFIX_PAGE
    sched = DecodeScheduler(model, params, n_slots=4, cache_len=256,
                            kv_page_tokens=pt)
    need(set(sched.kernel_modes().values()) == {"cuda"},
         f"scheduler kernel modes {sched.kernel_modes()}")
    before = ops.registry.dispatch_snapshot()
    lead = sched.generate(GenerateSpec(prompt=prompts[-1], n_new=MOE_NEW))
    rest = run_concurrent(sched, [GenerateSpec(prompt=p, n_new=MOE_NEW)
                                  for p in prompts[:-1]], {})
    torch.cuda.synchronize()
    st = sched.stats()
    got = delta(before)
    need_counts(got, {k: len(prompts) * per_fwd.get(k, 0)
                      + st["steps"] * per_step.get(k, 0)
                      for k in set(per_fwd) | set(per_step)},
                f"{label} scheduler")
    hits = [(len(p) - 1) // pt for p in prompts[:-1]]
    print(f"  scheduler, {label}: the {len(prompts[-1])}-token prompt "
          f"alone, then {len(rest)} reusing its pages; {st['steps']} "
          f"steps, prefix hits {st['kv_prefix_hits']} pages (expected "
          f"{sum(hits)}), decode_attention_paged "
          f"{got['decode_attention_paged']} launches "
          f"({st['steps']} steps x {per_step['decode_attention_paged']}), "
          f"{st['kv_pages_pinned']} pinned")
    need(st["kv_prefix_hits"] == sum(hits) and st["kv_pages_pinned"] == 0,
         f"{label}: prefix stats {st}")
    sched.kvpool.check_invariants()
    return [r.tokens for r in rest + [lead]]


def check_prefix_tokens(model, params, prompts, results, refs, label: str):
    """The tokens of :func:`prefix_paged`'s run: the lead's equal
    ``reference_generate``'s (``refs``, MOE_NEW tokens each).  MoE
    capacity is per call, so a request that prefills only its suffix may
    keep other tokens than the whole prompt's prefill; the JAX package's
    paged scheduler does the same (its tokens equal the port's on a
    case with capacity drops: ``tests/test_torch_chunked_prefill.py``).
    So each of the others is held to the same split through the slotted
    model (:func:`segmented_generate`), which the pages, tables and
    gathers must reproduce bit for bit, and ``refs`` are printed
    beside."""
    pt = PREFIX_PAGE
    check_tokens(f"{label} alone", prompts[-1:], results[-1:], refs[-1:],
                 n=MOE_NEW)
    for p, r, ref in zip(prompts[:-1], results, refs):
        h = (len(p) - 1) // pt
        want = segmented_generate(model, params, p, h * pt, MOE_NEW)
        print(f"  {label} prompt {len(p)} ({h * pt} tokens from prefix "
              f"pages): {'equal to' if r == want else 'DIFFERS from'} the "
              f"same split through the slotted model; "
              f"{'equal to' if r == ref else 'differs from'} the whole "
              f"prompt's reference_generate (first difference at "
              f"{first_diff(ref, r)})")
        need(r == want, f"{label} prompt {len(p)} differs from its split "
             f"through the slotted model at token {first_diff(want, r)}")


def arctic_chunked(model32, params32) -> dict:
    """Arctic's chunked prefill past its capacity drops, on the f32 params
    of one full-width layer: B 1, S CHUNK_PROMPT, ``prefill_chunked`` with
    CHUNK rows against the unchunked ``prefill``, exact launches, ms and
    peak memory (:func:`prefill_run`).  The capacity is per call (C 40 a
    chunk of 2048, 160 for the prompt), so the tokens dropped differ; with
    one layer attention precedes the MoE, so every cache leaf agrees
    within CHUNK_TOL (each cache is its rows' K/V projection bit for bit,
    :func:`kv_by_rows`, and the f32 K/V products of 2048 rows and of 8192
    need not round alike), and the last chunk's logits
    agree within ARCTIC_CHUNK_REL of max |logit| at every token whose
    keep pattern (:func:`keep_pattern` of each router call's weights,
    recorded by :func:`route_spy`) both runs share.  Some token must be
    dropped.  Returns the launches of the two timed runs."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    cfg = model32.cfg
    dev = model32.device
    g = torch.Generator(device=dev).manual_seed(11)
    B, S = 1, CHUNK_PROMPT
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device=dev)}
    ops.registry.reset_counts()
    runs = {"unchunked": prefill_run(model32, params32, batch, S),
            "chunked": prefill_run(model32, params32, batch, S, CHUNK)}
    path = ops.registry.dispatch_snapshot()
    need_exact(runs["unchunked"]["counts"], chunk_counts(cfg, 1),
               "arctic unchunked prefill")
    need_exact(runs["chunked"]["counts"], chunk_counts(cfg, S // CHUNK),
               "arctic chunked prefill")
    print_runs(f"arctic-480b 1 layer f32 B {B} S {S}", runs)
    del runs
    spied = {}
    for side, chunk in (("unchunked", None), ("chunked", CHUNK)):
        cache = model32.init_cache(B, S)
        with route_spy() as spy:
            if chunk:
                lg, _ = model32.prefill_chunked(params32, batch, cache,
                                                chunk=chunk)
            else:
                lg, _ = model32.prefill(params32, batch, cache)
        w_te = torch.cat(spy.weights, dim=1)
        kept = torch.cat([keep_pattern(cfg, w) for w in spy.weights], dim=1)
        spied[side] = {"last": lg[:, -CHUNK:].clone(), "cache": cache,
                       "calls": len(spy.weights), "w_te": w_te,
                       "kept": kept, "drops": dropped_tokens(w_te, kept)}
        del lg
    u, c = spied["unchunked"], spied["chunked"]
    need(u["calls"] == cfg.n_layers and
         c["calls"] == cfg.n_layers * S // CHUNK,
         f"arctic: {u['calls']} and {c['calls']} router calls recorded")
    cache = [close_report(b, a, CHUNK_TOL) + (torch.equal(a, b),)
             for a, b in zip(tree_util.leaves(u["cache"]),
                             tree_util.leaves(c["cache"]))]
    same_w = torch.equal(u["w_te"], c["w_te"])
    tail = slice(S - CHUNK, S)
    shared = (u["kept"][:, tail] == c["kept"][:, tail]).all(dim=-1)
    diff = (u["last"] - c["last"]).abs().amax(dim=-1).cpu()     # (B, CHUNK)
    scale = u["last"].abs().max().item()
    n_cmp = int(shared.sum())
    worst = diff[shared].max().item() if n_cmp else float("nan")
    other = diff[~shared].max().item() if n_cmp < shared.numel() else 0.0
    print(f"  arctic chunked against unchunked, {S} tokens, chunks of "
          f"{CHUNK}: every cache leaf within {max(d for _, d, _ in cache):.3e}"
          f" (tol {CHUNK_TOL}; "
          f"{'all' if all(e for *_, e in cache) else 'not all'} bit-equal); "
          f"routing weights {'bit-equal' if same_w else 'differ'}; tokens "
          f"dropped "
          f"(a chosen expert over capacity) unchunked {u['drops']} (C "
          f"{moe.capacity(cfg, S)}), chunked {c['drops']} (C "
          f"{moe.capacity(cfg, CHUNK)} a chunk); the last chunk's "
          f"{CHUNK} tokens: {n_cmp} keep the same experts in both runs, "
          f"their logits within {worst:.3e} ({worst / scale:.3e} of max "
          f"|logit| {scale:.3f}, limit {ARCTIC_CHUNK_REL}); the "
          f"{CHUNK - n_cmp} others up to {other:.3e}")
    need(all(ok for ok, *_ in cache),
         f"arctic: a cache leaf differs chunked against unchunked beyond "
         f"{CHUNK_TOL}")
    rebuilt, normed, products = kv_by_rows(model32, params32, batch,
                                           u["cache"], c["cache"], CHUNK)
    print(f"  the cause: each cache {'equals' if rebuilt else 'DIFFERS from'}"
          f" bit for bit the K and V that qkv_project gives its rows (the "
          f"prompt's {S} at once, unchunked; each chunk's {CHUNK} alone, "
          f"chunked); the normed rows {'equal' if normed else 'DIFFER'} "
          f"chunked and unchunked; the f32 K and V products of a chunk's "
          f"rows alone against the same rows of the {S}-row product, "
          f"chunk by chunk: max abs diff "
          + ", ".join(f"{d:.3e}" for d in products))
    need(rebuilt, "arctic: a cache is not the K/V of its rows' projection")
    need(all(e for *_, e in cache) or max(products) > 0,
         "arctic: the cache leaves differ, the K/V products by row count "
         "do not")
    need(max(u["drops"], c["drops"]) > 0,
         "arctic: no token was dropped, the check sees no capacity drop")
    need(n_cmp > 0 and worst <= ARCTIC_CHUNK_REL * scale,
         f"arctic: the last chunk's logits differ by {worst:.3e} at tokens "
         f"with the same keep pattern (max |logit| {scale:.3f})")
    del spied, u, c
    torch.cuda.empty_cache()
    return path


def kv_by_rows(model32, params32, batch, cache_whole, cache_chunked,
               chunk: int) -> tuple:
    """Where a one-layer prefill's cache comes from, chunked or not: its
    K and V rebuilt with ``layers.qkv_project`` over the prompt's rows at
    once (:func:`~repro_torch.models.transformer.block_prefill`'s call)
    and over each ``chunk`` rows alone (``block_chunk``'s), held bit for bit
    to ``cache_whole`` and ``cache_chunked``; and the K and V products
    (``quant.einsum`` of the normed rows with ``wk``, ``wv``) of each
    chunk's rows alone against the same rows of the whole prompt's.
    Returns (both caches rebuilt exactly, each chunk's normed rows equal
    to the same rows normed with the prompt's, the products' max abs
    diff chunk by chunk)."""
    import torch
    from repro_torch import quant
    from repro_torch.models import layers
    cfg = model32.cfg
    (_, p), = model32._layers(params32["blocks"])
    (_, cu), = model32._layers(cache_whole)
    (_, cc), = model32._layers(cache_chunked)
    x = model32.embed(params32, batch)
    S, dev = x.shape[1], x.device
    h = layers.apply_norm(cfg, p["norm1"], x)
    _, k, v = layers.qkv_project(cfg, p["attn"], h,
                                 torch.arange(S, device=dev)[None, :])
    rebuilt = (torch.equal(cu["k"], k.transpose(1, 2).to(cu["k"].dtype))
               and torch.equal(cu["v"], v.transpose(1, 2).to(cu["v"].dtype)))
    whole = {n: quant.einsum(h, p["attn"][n], cfg.compute_dtype)
             for n in ("wk", "wv")}
    products, normed = [], True
    for off in range(0, S, chunk):
        rows = slice(off, off + chunk)
        hc = layers.apply_norm(cfg, p["norm1"], x[:, rows])
        normed = normed and torch.equal(hc, h[:, rows])
        _, k, v = layers.qkv_project(
            cfg, p["attn"], hc,
            (off + torch.arange(chunk, device=dev))[None, :])
        rebuilt = (rebuilt and torch.equal(
            cc["k"][:, :, rows], k.transpose(1, 2).to(cc["k"].dtype))
            and torch.equal(cc["v"][:, :, rows],
                            v.transpose(1, 2).to(cc["v"].dtype)))
        products.append(max(
            (quant.einsum(hc, p["attn"][n], cfg.compute_dtype)
             - w[:, rows]).abs().max().item() for n, w in whole.items()))
    return rebuilt, normed, products


def shm_workdir() -> str:
    """Phase 32's store directory in host memory (:data:`SHM`), named
    after this process's temporary directory: a run killed before its
    clean-up leaves its stores in host memory after it is gone, so the
    next run with the same ``TMPDIR`` removes them first."""
    import hashlib
    tag = hashlib.sha1(os.path.realpath(
        tempfile.gettempdir()).encode()).hexdigest()[:12]
    path = os.path.join(SHM, f"repro-smoke-{tag}")
    if os.path.exists(path):
        print(f"  removing {path}, left by a run that did not end: "
              f"{sorted(os.listdir(path))}")
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def moe_configs(dev) -> tuple:
    """Phase 32: :func:`mixtral_full`, then :func:`arctic_layer`, their
    stores in host memory (:func:`shm_workdir`).  Returns (their paths,
    phase 30's meta table)."""
    import ctypes
    # the C heap's free pages back to the host before 47 GB of store go
    # into its memory
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    workdir = shm_workdir()
    try:
        t0 = time.perf_counter()
        paths, table = mixtral_full(dev, workdir)
        print(f"  mixtral_full: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths.update(arctic_layer(dev, workdir))
        print(f"  arctic_layer: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    # the pinned read buffers cached by PyTorch's host allocator (arctic's
    # block: one of 16 GiB) back to the host for the later phases
    import torch
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    print(f"  host memory available after the phase "
          f"{mem_available() / 1e9:.1f} GB, this process "
          f"{rss_bytes() / 1e9:.1f} GB resident (the host allocator's "
          f"cache {'emptied' if empty else 'kept: no _host_emptyCache'})")
    return paths, table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the GPU",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import cuda_lib, ops
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = ops.registry.build()
    print(f"[2] kernel library {lib.path} built in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("    " + line.strip())

    phase("[3] kernels against their plain versions")
    report: dict = {}
    check_kernels(dev, report)

    # each path runs with the counts set to 0 just before it and read just
    # after; the kernels each must have launched
    paths = {}
    # phase 32 runs first: its stores take 47 GB of host memory (SHM),
    # which the later phases' caches (pinned read buffers, the C heap)
    # would not leave it
    phase("[32] the MoE configs at full size: mixtral-8x7b at 32 layers "
          "int8-resident (greedy generation, slotted and paged "
          "DecodeScheduler, a request past its window, the streamed "
          "oracle, a step's costs); one arctic-480b layer at full width "
          "(bf16 at A, int8-resident, f32 at A, both schedulers) and its "
          "chunked prefill past its capacity drops")
    moe_paths, table = moe_configs(dev)
    paths.update(moe_paths)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as wd:
        phase("[4] full-width smollm-360m cold starts")
        ops.registry.reset_counts()
        cs = cold_starts(dev, wd)
        phase("[5] greedy generation, 32 tokens")
        generate(cs["model"], cs["cast"].params, cs["cfg"])
        paths["cold starts + generation"] = (
            ops.registry.dispatch_snapshot(),
            ("flash_attention", "decode_attention", "weight_transform",
             "rmsnorm"))
        cs["oracle"] = f32_oracle(dev, cs)
        phase("[6] int8-resident (compute_quant) cicada cold start")
        ops.registry.reset_counts()
        params_q, first = quant_cold_start(dev, cs)
        paths["int8-resident cold start"] = (
            ops.registry.dispatch_snapshot(),
            ("flash_attention", "quant_matmul", "rmsnorm"))
        phase("[7] DecodeScheduler, slotted: 4 slots, prompts 37/64/100/128,"
              " 32 greedy tokens each")
        slotted = scheduler_slotted(cs, params_q, first)
        paths["scheduler, slotted"] = (
            slotted["launches"],
            ("flash_attention", "quant_matmul", "decode_attention",
             "rmsnorm"))
        phase("[8] DecodeScheduler, paged: 16-token pages, prefix reuse")
        paged = scheduler_paged(cs, params_q, first, slotted)
        paths["scheduler, paged"] = (
            paged["launches"],
            ("flash_attention", "quant_matmul", "decode_attention_paged",
             "rmsnorm"))
        del cs, params_q
        phase("[9] card against CPU, 4 layers at full width, f32")
        card_vs_cpu(dev, wd)
        for i, arch in enumerate(RECURRENT):
            phase(f"[{10 + i}] full-width {arch} at "
                  f"{RECURRENT_LAYERS[arch]} layers: cicada cold start "
                  f"({RECURRENT[arch] or 'f32'} store, bf16 at A), greedy "
                  f"generation, slotted and paged DecodeScheduler (4 "
                  f"requests); int8-resident cold start, slotted and paged")
            paths.update(recurrent_family(dev, wd, arch))
            torch.cuda.empty_cache()
        for i, arch in enumerate(RECURRENT):
            phase(f"[{12 + i}] card against CPU, {arch} at 4 layers of full "
                  f"width, f32")
            card_vs_cpu_arch(dev, wd, arch)
        phase("[15] serverless platform, full width: smollm-360m (4 "
              "layers) and recurrentgemma-2b (5 layers) int8 stores, a "
              "16-invocation trace replayed serially and at concurrency 4;"
              " smollm-360m int8-resident, paged against slotted")
        plat = serverless_platform(dev, wd)
        paths["serverless platform"] = (plat["launches"], plat["kernels"])
        phase("[16] the paper's trio at full width (resnet50, vgg16, "
              "vit_b_16): five strategies from f32 stores, cicada from "
              "int8")
        ops.registry.reset_counts()
        vis = vision_cold_starts(dev, wd)
        paths["vision cold starts"] = (ops.registry.dispatch_snapshot(),
                                       ("weight_transform",))
        time_vgg_fc1(dev)
        phase("[17] card against CPU, the trio at full width, f32")
        vision_card_vs_cpu(wd, vis)
        phase("[18] one-shot serving of the trio: int8 stores, a "
              "16-invocation trace replayed serially")
        vplat = vision_platform(dev, wd)
        paths["vision platform"] = (vplat["launches"], ("weight_transform",))
        phase("[19] the autoscaled platform: smollm-360m (4 layers) int8 "
              "store, no cache, a 10x burst open-loop, without and with the "
              "autoscaler, under the lock probe")
        auto = autoscaled_platform(dev, wd)
        paths["autoscaled platform"] = (
            auto["launches"],
            ("flash_attention", "decode_attention", "weight_transform",
             "rmsnorm"))
        torch.cuda.empty_cache()
        phase(f"[20] full-width mixtral-8x7b at {MIXTRAL_LAYERS} of 32 "
              f"layers: int8 store, cicada with bf16 at A and "
              f"int8-resident, greedy generation, slotted DecodeScheduler "
              f"on both, rows probe")
        mix = mixtral_family(dev, wd)
        paths["mixtral-8x7b"] = (mix["launches"], mix["kernels"])
        phase(f"[21] card against CPU, mixtral-8x7b at {MIXTRAL_LAYERS} "
              f"layers, f32 from the int8 store, routing compared")
        mixtral_card_vs_cpu(wd, mix)
        del mix
        torch.cuda.empty_cache()
        phase("[22] arctic-480b smoke: card against CPU, paged "
              "DecodeScheduler with prefix reuse")
        arc = arctic_smoke(dev, wd)
        paths["arctic-480b smoke"] = (arc["launches"], arc["kernels"])
        phase("[23] full-width hubert-xlarge (48 layers): int8 store, "
              "cicada with bf16 at A, one-shot forward; card against CPU "
              "at 4 layers")
        hub = hubert_family(dev, wd)
        paths["hubert-xlarge"] = (hub["launches"], hub["kernels"])
        torch.cuda.empty_cache()
        phase(f"[24] full-width internvl2-76b at {INTERNVL_LAYERS} of 80 "
              f"layers: int8 store, cicada with bf16 at A on image rows and "
              f"tokens, greedy generation; card against CPU")
        vlm = internvl_family(dev, wd)
        paths["internvl2-76b"] = (vlm["launches"], vlm["kernels"])
        torch.cuda.empty_cache()
        phase(f"[25] the cluster on one card: smollm-360m (4 layers) int8 "
              f"store, {CLUSTER_NODES} nodes, peer exchange over a "
              f"{CLUSTER_LINK_MBPS:.0f} MB/s link: pinned cold starts, a "
              f"cold burst with and without peers, a trace through the "
              f"front end, under the lock probe")
        clus = cluster_platform(dev, wd)
        paths["cluster"] = (
            clus["launches"],
            ("flash_attention", "decode_attention", "weight_transform",
             "rmsnorm"))
        torch.cuda.empty_cache()
        phase(f"[26] shard-granular cold starts on a logical {SHARD_MESH} "
              f"mesh, a store channel a device: smollm-360m f32 and int8 "
              f"against one device, a cache-served reload, a pool "
              f"scale-out, launch/serve.py --mesh 4, mixtral-8x7b int8, "
              f"under the lock probe")
        shard = sharded_cold_starts(dev, wd)
        paths["sharded cold start"] = (
            shard["launches"],
            ("weight_transform", "flash_attention", "rmsnorm"))
        torch.cuda.empty_cache()
        phase(f"[27] training on the card: the backward kernels against "
              f"plain, card against CPU at 2 layers, full-width "
              f"smollm-360m through launch/train.py ({TRAIN_STEPS} steps, "
              f"--compress-grads, a checkpoint), determinism and resume")
        train = training(dev, wd, report)
        paths["training"] = (
            train["launches"],
            ("flash_attention", "flash_attention_bwd", "rmsnorm",
             "rmsnorm_bwd"))
        torch.cuda.empty_cache()
        phase(f"[28] training every family: the scans' backward kernels "
              f"against plain, card against CPU, full-width mamba2-780m and "
              f"recurrentgemma-2b through launch/train.py ({TRAIN28_STEPS} "
              f"steps), then mixtral-8x7b, hubert-xlarge, internvl2-76b and "
              f"arctic-480b smoke through make_train_step")
        fam = train_families(dev, report)
        paths["training every family"] = (
            fam["launches"],
            ("ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd",
             "flash_attention", "flash_attention_bwd", "rmsnorm",
             "rmsnorm_bwd"))
        torch.cuda.empty_cache()
        phase(f"[29] chunked prefill at full width ({CHUNK}-token chunks): "
              f"smollm-360m f32 B 2 S {CHUNK_PROMPT} against unchunked "
              f"and {CHUNK_STEPS} decode steps; smollm-360m bf16 S "
              f"{LONG_PROMPT} and internvl2-76b ({INTERNVL_LAYERS} layers) "
              f"bf16 S {CHUNK_PROMPT} against unchunked and f32")
        chunked = chunked_prefill(dev)
        paths["chunked prefill"] = (chunked["launches"], chunked["kernels"])
        torch.cuda.empty_cache()
        phase("[30] the dry run against the card: every cell on meta on "
              "both production meshes, then five cells at full width and "
              "depth (batch cut) traced on meta and run on the card")
        dry = dryrun_phase(dev, table)
        paths["dry run cells"] = (dry["launches"], dry["kernels"])
        torch.cuda.empty_cache()
        phase("[31] the dense configs at full width ("
              + ", ".join(f"{a} {n} layers" for a, n, _ in DENSE_FULL)
              + "): int8 stores deployed one "
              "unit at a time, cicada with bf16 at A and int8-resident, "
              "greedy generation, slotted and paged DecodeScheduler, "
              f"danube {WINDOW_PROMPT - 4096} tokens past its window; card "
              "against CPU")
        paths.update(dense_configs(dev, wd))
        for path, (counts, kernels) in paths.items():
            print(f"    launches on {path}: {counts}")
            for name in kernels:
                need(counts[name] > 0,
                     f"kernel {name} was not launched on {path}")
        launches = {n: sum(c[n] for c, _ in paths.values())
                    for n in ops.registry.names()}

    kernels = []
    for name in ops.registry.names():
        spec = ops.registry.spec(name)
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": launches[name],
            "launches_by_path": {p: c[name] for p, (c, _) in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r.get("library"), "shape": r["shape"],
            "library_device_ms": r.get("library_device_ms"),
            "bounds": r.get("bounds"),
            "more": EXTRA.get(name, [])})
    need(cuda_lib.status()["built"], "kernel library not loaded")
    phase("done")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
