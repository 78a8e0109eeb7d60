"""Roofline of a dry-run record on the NVIDIA H100: the twin of
``benchmarks/roofline.py``'s ``model_flops`` and ``analyze``.

Three terms a cell, from the per-device numbers of
:mod:`repro_torch.launch.dryrun`:

    compute term    = flops a device / PEAK_FLOPS        (989 TFLOP/s bf16)
    memory term     = bytes a device / HBM_BPS           (3.35 TB/s)
    collective term = collective bytes a device / LINK_BPS  (450 GB/s)

beside MODEL_FLOPS = 6 N D for a train step, 2 N D for a prefill and 2 N B
for a decode step (N the active parameters, the top-k experts' for MoE; D
the tokens), the usefulness ratio MODEL_FLOPS / counted FLOPs (remat and
redundant work) and the roofline fraction.  The reference's peaks are a
TPU v5e's and do not carry over.  It lives in the port's package because
``benchmarks/`` is the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.configs import SHAPES
from repro_torch.models.api import get_config

# NVIDIA H100 SXM5 80GB, data sheet, dense (no sparsity), at its 700 W
# limit: bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores,
# HBM3 bytes/s, HBM bytes
PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BPS = 3.35e12
HBM_BYTES = 80e9
# NVLink 4 of an H100 SXM5: 900 GB/s both directions, 450 GB/s each way
LINK_BPS = 450e9

LEVERS = {
    "compute": "raise arithmetic efficiency: skip masked work, drop remat "
               "recompute on cheap layers",
    "memory": "cut HBM traffic: fuse the eager elementwise ops, bf16 "
              "activations, keep weights resident across microbatches",
    "collective": "reshard: move the gather/reduce off the critical axis, "
                  "overlap collectives with compute, int8-compress the DP "
                  "reduce",
}


def model_flops(arch: str, shape: str, *, batch: Optional[int] = None,
                seq: Optional[int] = None, smoke: bool = False) -> float:
    """The reference's MODEL_FLOPS of a cell; ``batch`` and ``seq`` cut
    the cell (a run at a smaller batch than the published one)."""
    cfg = get_config(arch, smoke=smoke)
    cell = SHAPES[shape]
    b = cell.batch if batch is None else batch
    s = cell.seq if seq is None else seq
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * s * b
    if cell.kind == "prefill":
        return 2.0 * n * s * b
    return 2.0 * n * b                   # decode: one token a row


def terms(flops: float, nbytes: float, coll: float = 0.0) -> Dict[str, Any]:
    """The three times (s) of a device's work and the one that bounds."""
    t = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BPS,
         "collective": coll / LINK_BPS}
    dom = max(t, key=t.get)
    return {"t_compute_s": t["compute"], "t_memory_s": t["memory"],
            "t_collective_s": t["collective"], "dominant": dom,
            "bound_s": t[dom]}


def analyze(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The roofline of one ``ok`` dry-run record with costs, else None."""
    if rec.get("status") != "ok" or "cost_per_device" not in rec:
        return None
    c = rec["cost_per_device"]
    devices = rec["devices"]
    out = terms(c["flops"], c["bytes"], c["collectives"]["total"])
    mf = model_flops(rec["arch"], rec["shape"],
                     smoke=rec.get("smoke", False),
                     batch=rec.get("batch"), seq=rec.get("seq"))
    counted = c["global"]["flops"]
    out.update({
        "arch": rec["arch"], "shape": rec["shape"], "model_flops": mf,
        "counted_flops_global": counted,
        "useful_ratio": mf / counted if counted else 0.0,
        # useful model FLOPs a second at the bound, over the peak
        "roofline_frac": mf / devices / max(out["bound_s"], 1e-12)
        / PEAK_FLOPS,
        "fits_hbm": rec["memory"]["fits_hbm_80g"],
        "live_gib": rec["memory"]["live_bytes_per_device"] / 2 ** 30,
        "lever": LEVERS[out["dominant"]]})
    return out
