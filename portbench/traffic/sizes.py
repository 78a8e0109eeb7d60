"""Stratified draws shared by the generators."""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np


def quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """The n mid-quantiles ((i + 0.5) / n) of a size distribution:
    ``{"dist": "fixed", "value": v}``, ``{"dist": "loguniform", "lo",
    "hi"}`` (whole numbers) or ``{"dist": "exponential", "mean"}``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, dist["value"], dtype=np.float64)
    if kind == "loguniform":
        lo, hi = math.log(dist["lo"]), math.log(dist["hi"])
        return np.rint(np.exp(lo + u * (hi - lo)))
    if kind == "exponential":
        return -dist["mean"] * np.log1p(-u)
    raise ValueError(f"unknown size distribution {kind!r}")


def stratified(dist: Dict[str, Any], n: int, block: int,
               rng: np.random.Generator) -> np.ndarray:
    """n values; each consecutive block of ``block`` holds the block's
    quantiles in an order drawn from ``rng``."""
    q = quantiles(dist, block)
    out = [q[rng.permutation(block)] for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]
