#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py

Drives the port's main path once: a full-width smollm-360m cold start
through the Cicada pipeline (cicada with the cast kernel, cicada with the
dequant kernel, pisel), then greedy generation on the assembled params.
It builds the three CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, checks that the
main path launched every kernel, checks the card against the CPU end to
end, and prints one JSON line of kernel numbers and, last, one JSON line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.

Without a CUDA device, or without the repository's ``src/repro_torch``
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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


class Failure(Exception):
    pass


def need(cond: bool, what: str):
    if not cond:
        raise Failure(what)


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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, report: dict):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import weight_transform as wmod

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # --- weight_transform: exact ------------------------------------------
    err = 0.0
    cases = []
    for n, m in [(14400, 64), (960, 960), (49152, 960), (17, 300)]:
        w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(m, generator=g, device=dev) * 0.05
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"dequant ({n},{m})->{str(dt)[6:]}", w, s, dt))
    buf = torch.randint(-127, 128, (17 * 300 + 1,), generator=g, device=dev,
                        dtype=torch.int8)
    cases.append(("dequant misaligned (17,300)->bfloat16",
                  buf[1:].view(17, 300), torch.rand(300, device=dev),
                  torch.bfloat16))
    for n, m in [(49152, 960), (17, 300)]:
        cases.append((f"cast ({n},{m}) f32->bf16", randn(n, m), None,
                      torch.bfloat16))
    for name, w, s, dt in cases:
        got = wmod.weight_transform(w, s, out_dtype=dt)
        want = wmod.plain(w, s, out_dtype=dt)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = max(err, (got.float() - want.float()).abs().max().item())
        print(f"  weight_transform {name}: "
              f"{'exact' if same else 'MISMATCH'}")
        need(same, f"weight_transform {name} differs from its plain version")
    # main-path timing shape: the largest leaf, tok (49152, 960) int8 -> f32
    n, m = 49152, 960
    w = torch.randint(-127, 128, (n, m), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(m, generator=g, device=dev) * 0.05
    b_ms, b_by = bound(n * m * 1 + m * 4 + n * m * 4, n * m, torch.float32)
    report["weight_transform"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: wmod.weight_transform(w, s,
                                                   out_dtype=torch.float32)),
        call_ms=call_ms(lambda: wmod.weight_transform(w, s,
                                                      out_dtype=torch.float32)),
        plain_ms=device_ms(lambda: wmod.plain(w, s,
                                              out_dtype=torch.float32)),
        library_ms=device_ms(lambda: (w.float() * s).to(torch.float32)),
        bound_ms=b_ms, bound_by=b_by,
        shape="int8 (49152, 960) + f32 scale (960,) -> f32")
    wf = randn(n, m)
    print(f"  weight_transform cast (49152,960) f32->bf16: "
          f"{device_ms(lambda: wmod.weight_transform(wf, None)):.4f} ms, "
          f"bound {bound(n * m * 6, 0, torch.float32)[0]:.4f} ms")

    # --- flash_attention -----------------------------------------------------
    fl_err = 0.0
    flash_cases = [
        (1, 15, 5, 37, 37, 64, True, 0), (1, 15, 5, 128, 128, 64, True, 0),
        (1, 15, 5, 1000, 1000, 64, True, 0),
        (1, 15, 5, 100, 164, 64, True, 0), (1, 15, 5, 128, 128, 64, True, 16),
        (1, 15, 5, 128, 128, 64, False, 0), (1, 15, 5, 77, 77, 64, False, 16),
        (2, 8, 2, 70, 70, 128, True, 0)]
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
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(2 * (2 * S * H * dh + 2 * S * K * dh),
                       4 * dh * pairs * H, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    report["flash_attention"] = dict(
        max_abs_err=fl_err,
        ms=device_ms(lambda: fmod.flash_attention(q, k, v, causal=True)),
        call_ms=call_ms(lambda: fmod.flash_attention(q, k, v, causal=True)),
        plain_ms=device_ms(lambda: fmod.plain(q, k, v, causal=True)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q (1,128,15,64), k/v (1,128,5,64), causal")
    S = 1000
    q = randn(1, S, H, dh, dtype=torch.bfloat16)
    k = randn(1, S, K, dh, dtype=torch.bfloat16)
    v = randn(1, S, K, dh, dtype=torch.bfloat16)
    b_long = bound(2 * (2 * S * H * dh + 2 * S * K * dh),
                   4 * dh * (S * (S + 1) // 2) * H, torch.bfloat16)[0]
    print(f"  flash_attention S=1000 bf16 causal: "
          f"{device_ms(lambda: fmod.flash_attention(q, k, v)):.4f} ms, bound "
          f"{b_long:.4f} ms")

    # --- decode_attention ---------------------------------------------------
    de_err = 0.0
    for (S_max, pos, win) in [(512, (0, 37, 300, 511), 0),
                              (128, (5, 127, 300, 1000), 128)]:
        for dt, tol in ((torch.bfloat16, BF16_ATOL),
                        (torch.float32, F32_ATOL)):
            B, H, K, dh = 4, 15, 5, 64
            q = randn(B, H, dh, dtype=dt)
            kc = randn(B, K, S_max, dh, dtype=dt)
            vc = randn(B, K, S_max, dh, dtype=dt)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            got = dmod.decode_attention(q, kc, vc, p, window=win)
            want = dmod.plain(q, kc, vc, p, window=win)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            de_err = max(de_err, e)
            print(f"  decode_attention B={B} S_max={S_max} pos={pos} "
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
    b_ms, b_by = bound(2 * (2 * H * dh) + 4 + 2 * 2 * rows * K * dh,
                       4 * H * dh * rows, torch.bfloat16)
    q4 = q[:, :, None]
    report["decode_attention"] = dict(
        max_abs_err=de_err,
        ms=device_ms(lambda: dmod.decode_attention(q, kc, vc, p)),
        call_ms=call_ms(lambda: dmod.decode_attention(q, kc, vc, p)),
        plain_ms=device_ms(lambda: dmod.plain(q, kc, vc, p)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q4, kc[:, :, :rows], vc[:, :, :rows], enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape="bf16 q (1,15,64), cache (1,5,256,64), pos 159")
    for name, r in report.items():
        print(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms on the "
              f"device ({r['call_ms']:.4f} ms per eager call), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def cold_starts(dev, workdir: str):
    import numpy as np
    import torch
    from repro_torch.core import ColdStartEngine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.serving.api import GenerateSpec
    from repro_torch.serving.decode import sample_first
    from repro_torch.store.store import (BandwidthModel, WeightStore,
                                         deploy_model)

    cfg = get_config("smollm-360m")
    model = transformer.build(cfg)
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
    del units
    print(f"  deployed smollm-360m ({cfg.param_count() / 1e6:.1f} M params) "
          f"f32 {store.model_nbytes('smollm') / 1e9:.3f} GB, int8 "
          f"{store.model_nbytes('smollm-int8') / 1e9:.3f} GB in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")

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
    return model, results[loads[0][0]].params, cfg


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


# ---------------------------------------------------------------------------
# phase 6: the card against the CPU, end to end
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
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 64))
    batch = {"tokens": torch.as_tensor(prompt)}
    got = {}
    for name, m, d in (("card", gpu_model, None), ("cpu", cpu_model, "cpu")):
        eng = ColdStartEngine(m, "smollm4", store, strategy="cicada",
                              device=d)
        res = eng.load(batch)
        toks = reference_generate(m, res.params, prompt[0], n_new=16,
                                  device=d)
        got[name] = (res.logits.float().cpu(), toks, res.params)
    a, b = got["card"][0], got["cpu"][0]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"  4-layer full-width f32: card vs CPU logits max rel diff "
          f"{rel:.3e} (tol 2e-3)")
    need(rel <= 2e-3, f"card and CPU logits differ by {rel}")
    ta, tb = got["card"][1], got["cpu"][1]
    print(f"  16 greedy tokens card {ta}\n                      cpu  {tb}")
    if ta != tb:
        i = next(j for j, (x, y) in enumerate(zip(ta, tb)) if x != y)
        # logit margin of the CPU's choice at the first differing position
        params = got["cpu"][2]
        seq = torch.as_tensor(np.concatenate([prompt[0], tb[:i]]))[None]
        lg, _ = cpu_model.forward(params, {"tokens": seq})
        top = torch.topk(lg[0, -1].float(), 2).values
        margin = (top[0] - top[1]).item()
        print(f"  first differing token at position {i}: CPU logit margin "
              f"{margin:.3e}")
        need(margin <= 2e-3 * lg.abs().max().item(),
             f"greedy tokens differ at {i} with margin {margin}")


# ---------------------------------------------------------------------------

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

    print("[3] kernels against their plain versions")
    report: dict = {}
    check_kernels(dev, report)

    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as wd:
        print("[4] full-width smollm-360m cold starts")
        ops.registry.reset_counts()
        model, params, cfg = cold_starts(dev, wd)
        print("[5] greedy generation, 32 tokens")
        generate(model, params, cfg)
        launches = ops.registry.dispatch_snapshot()
        print(f"    kernel launches on the main path: {launches}")
        for name, n in launches.items():
            need(n > 0, f"kernel {name} was not launched on the main path")
        del model, params
        print("[6] card against CPU, 4 layers at full width, f32")
        card_vs_cpu(dev, wd)

    kernels = []
    for name in ops.registry.names():
        mod = ops.registry.spec(name).module
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    need(cuda_lib.status()["built"], "kernel library not loaded")
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
