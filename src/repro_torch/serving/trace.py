"""Bursty serverless invocation workload (paper Sec. IV-B, Fig. 8), a
port of ``repro.serving.trace``.

The paper drives its evaluation with day 14 of the Azure Functions
trace (1,980,951 invocations over 14 days; 2,426 invocations sampled
over one hour, assigned randomly to the evaluated models).  The raw
trace is not shipped with the repository, so a statistically similar
arrival process is generated instead:

  * doubly-stochastic Poisson process: a log-normal–modulated per-minute
    rate envelope (burst factor matching Fig. 8's spiky shape, where
    per-minute counts swing between ~10 and ~120);
  * total invocation count and horizon match the paper (2,426 over 1 h);
  * invocations are assigned uniformly at random to the model set,
    mirroring the paper's "randomly assigning functions to the
    evaluated models".

Everything is seeded and deterministic: a seed gives the same
invocation list as the reference's (``repro.serving.trace``), draw for
draw.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Invocation:
    t: float                  # arrival time (seconds from epoch 0)
    model: str
    req_id: int


def per_minute_envelope(minutes: int, mean_per_min: float, *,
                        burstiness: float = 0.9,
                        seed: int = 0) -> np.ndarray:
    """Log-normal modulated rates with occasional bursts (Fig. 8 shape)."""
    rng = np.random.default_rng(seed)
    base = rng.lognormal(mean=0.0, sigma=burstiness, size=minutes)
    # sparse bursts: ~8% of minutes spike 2-4x
    burst_mask = rng.random(minutes) < 0.08
    base[burst_mask] *= rng.uniform(2.0, 4.0, burst_mask.sum())
    rates = base / base.mean() * mean_per_min
    return rates


def azure_like_trace(*, duration_s: float = 3600.0,
                     n_invocations: int = 2426,
                     models: Sequence[str],
                     seed: int = 0) -> List[Invocation]:
    """Generate the full arrival sequence."""
    rng = np.random.default_rng(seed + 1)
    minutes = max(int(np.ceil(duration_s / 60.0)), 1)
    rates = per_minute_envelope(minutes, n_invocations / minutes, seed=seed)
    counts = rng.poisson(rates)
    # rescale to hit the exact invocation count
    while counts.sum() != n_invocations:
        diff = n_invocations - counts.sum()
        idx = rng.integers(0, minutes, abs(diff))
        if diff > 0:
            np.add.at(counts, idx, 1)
        else:
            for i in idx:
                if counts[i] > 0:
                    counts[i] -= 1
    out: List[Invocation] = []
    rid = 0
    for m in range(minutes):
        ts = np.sort(rng.uniform(m * 60.0, min((m + 1) * 60.0, duration_s),
                                 counts[m]))
        for t in ts:
            out.append(Invocation(float(t), models[rng.integers(
                0, len(models))], rid))
            rid += 1
    return out


def summarize(trace: List[Invocation]) -> dict:
    per_min: dict = {}
    for inv in trace:
        per_min[int(inv.t // 60)] = per_min.get(int(inv.t // 60), 0) + 1
    counts = np.array(list(per_min.values()))
    return {"n": len(trace),
            "minutes": len(per_min),
            "per_min_mean": float(counts.mean()),
            "per_min_max": int(counts.max()),
            "per_min_min": int(counts.min()),
            "burst_ratio": float(counts.max() / max(counts.mean(), 1e-9))}
