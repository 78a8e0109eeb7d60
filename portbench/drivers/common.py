"""What the drivers share: the run's context, the port's ArchConfig from
a configuration file, and the per-request record."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from portbench.devtrace import DeviceTrace
from portbench.spans import Spans

ARCH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
             "vocab_size", "head_dim", "sliding_window", "rope_theta",
             "n_experts", "top_k", "capacity_factor")


@dataclasses.dataclass
class Ctx:
    cell: str
    wl: Dict[str, Any]          # the cell's file
    cfg: Dict[str, Any]         # the configuration's file
    mix: Dict[str, Any]         # the traffic mix's file
    seed: int
    seconds: float
    device: Any
    tmp: str                    # a directory of the run's own
    spans: Spans
    trace: DeviceTrace


def arch(cfg: Dict[str, Any]):
    """The port's ArchConfig for a configuration file."""
    from repro_torch.models.api import ArchConfig, Family
    return ArchConfig(name=cfg["name"], family=Family(cfg["family"]),
                      compute_dtype=dtype(cfg["serving"]["compute_dtype"]),
                      **{k: cfg[k] for k in ARCH_KEYS if k in cfg})


def cache_len(mix: Dict[str, Any]) -> int:
    """Positions a request of the mix can need: the longest prompt and
    the longest output."""
    def hi(d):
        return int(d["value"] if d["dist"] == "fixed" else d["hi"])
    return hi(mix["prompt"]) + hi(mix["output"])


def record(i: int, spec: Dict[str, Any], t_submit: float,
           t_due: Optional[float] = None) -> Dict[str, Any]:
    return {"id": i, "n_prompt": spec["n_prompt"], "n_new": spec["n_new"],
            "prompt": spec["prompt"], "t_due": t_submit if t_due is None
            else t_due, "t_submit": t_submit, "t_start": None,
            "t_first": None, "t_done": None, "tokens": None,
            "token_times": None, "cold": None, "load_s": None,
            "utilization": None, "queue_s": None, "ttft_s": None,
            "error": None}


def from_response(rec: Dict[str, Any], resp) -> None:
    """Fill a record from the router's Response."""
    rec.update(t_start=resp.t_arrival, t_done=resp.t_done, cold=resp.cold,
               load_s=resp.load_s, utilization=resp.utilization,
               queue_s=resp.queue_s, ttft_s=resp.ttft_s,
               tokens=[int(t) for t in np.asarray(resp.tokens)])
    rec["t_first"] = resp.t_arrival + resp.ttft_s
    times = [rec["t_first"]]
    for g in resp.tpot_s or []:
        times.append(times[-1] + g)
    rec["token_times"] = times


def from_result(rec: Dict[str, Any], res, t_start: float,
                t_done: float) -> None:
    """Fill a record from the scheduler's GenResult."""
    rec.update(t_start=t_start, t_done=t_done, tokens=list(res.tokens),
               token_times=list(res.token_times), t_first=res.t_first,
               queue_s=0.0, ttft_s=res.t_first - t_start)


def dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
