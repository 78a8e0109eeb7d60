"""Open loop: independent users arriving at ``load.rate_per_s`` a second
on average, with exponential gaps (Poisson arrivals), sent at their due
times however far behind the system runs.  Returns the requests with
their due offset from the window's start (``due_s``), up to
``seconds``.

Mix parameters: ``prompt`` and ``output`` size distributions,
``temperature`` (0: greedy)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.traffic.sizes import stratified


def generate(mix: Dict[str, Any], load: Dict[str, Any], seed: int,
             vocab: int, seconds: float) -> List[Dict[str, Any]]:
    rate = float(load["rate_per_s"])
    block = int(mix.get("block", 8))
    n = int(rate * seconds * 1.5) + 2 * block
    rng = np.random.default_rng(int(seed))
    gaps = stratified({"dist": "exponential", "mean": 1.0 / rate}, n,
                      block, rng)
    plen = stratified(mix["prompt"], n, block, rng).astype(int)
    olen = stratified(mix["output"], n, block, rng).astype(int)
    due = np.cumsum(gaps) - gaps[0]
    out = []
    for i in range(n):
        if due[i] >= seconds:
            break
        out.append({"due_s": float(due[i]), "n_prompt": int(plen[i]),
                    "n_new": int(olen[i]),
                    "prompt": rng.integers(0, vocab, int(plen[i]),
                                           dtype=np.int64),
                    "temperature": float(mix.get("temperature", 0.0))})
    return out
