"""Closed loop: ``load.clients`` clients, each sending its next request
when its reply is complete.  Returns one list of requests a client, in
the order it sends them (a client that runs out starts its list again).

Mix parameters: ``prompt`` and ``output`` size distributions
(:mod:`portbench.traffic.sizes`), ``per_client`` requests drawn a
client, ``temperature`` (0: greedy)."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from portbench.traffic.sizes import stratified


def generate(mix: Dict[str, Any], load: Dict[str, Any], seed: int,
             vocab: int) -> List[List[Dict[str, Any]]]:
    clients = int(load["clients"])
    per = int(mix["per_client"])
    n = clients * per
    block = max(clients, int(mix.get("block", 8)))
    rng = np.random.default_rng(int(seed))
    plen = stratified(mix["prompt"], n, block, rng).astype(int)
    olen = stratified(mix["output"], n, block, rng).astype(int)
    streams: List[List[Dict[str, Any]]] = [[] for _ in range(clients)]
    for i in range(n):                  # round-major: round r, client c
        streams[i % clients].append({
            "n_prompt": int(plen[i]), "n_new": int(olen[i]),
            "prompt": rng.integers(0, vocab, int(plen[i]), dtype=np.int64),
            "temperature": float(mix.get("temperature", 0.0))})
    return streams
