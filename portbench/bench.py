"""One run of one cell: set-up, the measured window, the metrics, the
check, and the result's line.

The order is fixed: the driver's set-up (counted in ``setup_s`` from the
process's start), the window (with ``--trace 1`` under the profiler from
its opening to its close, or to the end of the request open at its close
where one client sends one request at a time) and the drain of what it
admitted, the peak of device memory, the program's state dropped, then
the reference over the sample.  Nothing of JAX may be loaded when the
result is printed."""
from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from portbench import check as check_mod
from portbench import spec
from portbench.devtrace import DeviceTrace
from portbench.drivers import common
from portbench.records import window_requests
from portbench.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """This process's start on ``time.monotonic()``'s clock (the import
    of this module where /proc says nothing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def peak_entry(name: str) -> Optional[Dict[str, float]]:
    for key, val in spec.peaks().items():
        if not key.startswith("_") and key in name:
            return val
    return None


def reference_weights(cfg, seed, device):
    """The weights as the reference takes them, drawn anew from the seed:
    ``float`` units through the benchmark's int8 formula, ``int8`` units
    as values times scales, all f32."""
    from portbench import weights as W
    from portbench.reference.quant import int8_roundtrip
    if cfg["serving"]["weights"] == "int8":
        def get(unit, i):
            return {p: (v[0].float() * v[1] if isinstance(v, tuple) else v)
                    for p, v in W.int8_unit(cfg, unit, i, seed,
                                            device).items()}
    else:
        def get(unit, i):
            return {p: (int8_roundtrip(t) if t.dim() >= 2 else t)
                    for p, t in W.float_unit(cfg, unit, i, seed,
                                             device).items()}
    return get


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device=None, cfg_override: Optional[Dict[str, Any]] = None,
             mix_override: Optional[Dict[str, Any]] = None,
             wl_override: Optional[Dict[str, Any]] = None,
             t_start: Optional[float] = None, control: bool = False
             ) -> Tuple[Dict[str, Any], List[str]]:
    """Run one cell; returns (the result's object, the check's lines).
    ``device`` None means the card.  The overrides (tests, tools) replace
    a file's contents."""
    import torch
    t_start = process_start() if t_start is None else t_start
    wl = wl_override or spec.workload(cell)
    cfg = cfg_override or spec.config(wl["config"])
    mix = mix_override or spec.mix(wl["traffic"])
    on_card = device is None
    if on_card:
        from repro_torch.kernels import ops
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        ops.registry.build()
        torch.cuda.reset_peak_memory_stats(device)
    driver = spec.module("drivers", wl["driver"])
    tmp = tempfile.mkdtemp(prefix="portbench-")
    spans = Spans()
    dtrace = DeviceTrace(trace and on_card)
    ctx = common.Ctx(cell=cell, wl=wl, cfg=cfg, mix=mix, seed=seed,
                     seconds=seconds, device=device, tmp=tmp, spans=spans,
                     trace=dtrace)
    try:
        state = driver.setup(ctx)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.monotonic() - t_start
        rec = driver.window(ctx, state)
        mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
        driver.close(state)
        del state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        rec.update(cell=cell, cfg=cfg, wl=wl, seed=seed, setup_s=setup_s,
                   seconds=seconds)
        device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
        rec["peaks"] = peak_entry(device_name)
        spans.add_request_phases(rec["requests"])
        rec["trace"] = dtrace.summary(spans) if dtrace.enabled else None
        result, lines = _result(rec, ctx, trace, control)
        if rec["trace"]:
            lines[:0] = [f"device {k} {v}" for k, v in
                         sorted(rec["trace"]["family_s"].items())]
        result["device"] = {"platform": "gpu" if on_card else "cpu",
                            "kind": device_name,
                            "count": 1, "memory_peak_bytes": int(mem_peak)}
        if rec["trace"]:
            result["device"].update(busy_s=rec["trace"]["busy_s"],
                                    window_s=rec["trace"]["window_s"])
            result["breakdown"] = rec["trace"]["breakdown"]
        result["checks"] = result.pop("checks")
        return result, lines
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _result(rec, ctx, trace: bool, control: bool):
    reqs = window_requests(rec, served=False)
    failed = sum(1 for r in reqs if r["error"] is not None)
    metrics = {}
    for m in spec.metrics_for(ctx.cell, trace):
        if m["name"] == "setup_s":
            val = rec["setup_s"]
        else:
            val = spec.reader(m["name"], trace).read(rec)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    checks: Dict[str, Dict[str, Any]] = {}
    for name, (val, limit) in rec["checks"].items():
        checks[name] = {"value": val, "limit": limit}
    checks["failed"] = {"value": failed, "limit": 0}
    ck = ctx.wl["check"]
    lim = ck["limits"]
    sample = check_mod.choose(rec["requests"], ctx.seed, ck["requests"],
                              ck.get("tokens_each"))
    if sample:
        got = check_mod.readings(ctx.cfg, sample, reference_weights(
            ctx.cfg, ctx.seed, ctx.device), ctx.device, control=control)
        # a control run holds the control's numbers to the limits in the
        # program's place; the program's are printed beside them
        held = {f"control_{n}" if control else n for n in lim}
        for name, limit in lim.items():
            val = got[f"control_{name}"] if control else got[name]
            checks[name] = {"value": val, "limit": limit}
        extra = {k: v for k, v in got.items() if k not in held}
    else:
        checks["sample"] = {"value": 0, "limit": None}
        extra = {}
    extra.update(rec.get("notes", {}))
    correct = all(_holds(n, c) for n, c in checks.items())
    # the numbers compared, each beside its limit, come last
    lines = [f"reading {k} {v}" for k, v in extra.items()]
    lines += [f"check {n} {c['value']} limit {c['limit']}"
              for n, c in checks.items()]
    return ({"correct": correct, "attempted": len(reqs), "failed": failed,
             "metrics": metrics, "checks": checks, **(
                 {"readings": extra} if extra else {})}, lines)


def _holds(name: str, c: Dict[str, Any]) -> bool:
    return c["limit"] is not None and c["value"] <= c["limit"]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the control (the reference at the precision "
                    "below) in the program's place; such a run is not "
                    "correct")
    a = ap.parse_args(argv)
    import torch
    wl = spec.workload(a.workload)
    need = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                             control=bool(a.control))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
