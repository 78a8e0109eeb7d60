"""Synthetic-but-learnable data pipeline (the port's copy of
``repro.training.data``, which holds no JAX: numpy only, so a batch is
bit-equal to the reference's for the same ``(seed, step)``).

A seeded first-order Markov chain over the vocabulary (sparse row
support so the conditional entropy is well below log V): a model that
learns the bigram statistics drives the loss down — giving the training
examples/tests a real convergence signal with no external data.

The pipeline is sharding-aware: ``host_batches`` yields the *local*
slice of the global batch for this host (data-parallel loading), and
every batch is a pure function of (seed, step) — restart-safe resume
(the checkpoint records the step; no data-iterator state to persist)
and straggler-free (no inter-host coordination).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    vocab: int
    branching: int = 8          # successors per token
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.succ = rng.integers(0, self.vocab,
                                 (self.vocab, self.branching), np.int64)
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, self.vocab)
        self.cum = np.cumsum(probs, axis=1)

    def sample(self, batch: int, seq: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xC1CADA]))
        out = np.empty((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            k = (u[:, t:t + 1] < self.cum[out[:, t]]).argmax(axis=1)
            out[:, t + 1] = self.succ[out[:, t], k]
        return out

    def batch(self, batch: int, seq: int, step: int
              ) -> Dict[str, np.ndarray]:
        toks = self.sample(batch, seq, step)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def bigram_ce_floor(self, n: int = 4096) -> float:
        """Entropy of the chain — the loss floor a perfect model reaches."""
        probs = np.diff(np.concatenate(
            [np.zeros((self.vocab, 1)), self.cum], axis=1), axis=1)
        h = -(probs * np.log(np.maximum(probs, 1e-12))).sum(axis=1)
        return float(h.mean())


def host_batches(gen: MarkovLM, *, global_batch: int, seq: int,
                 host_id: int = 0, n_hosts: int = 1,
                 start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic per-host shard of the global batch stream."""
    local = global_batch // n_hosts
    step = start_step
    while True:
        full = gen.batch(global_batch, seq, step)
        yield {k: v[host_id * local:(host_id + 1) * local]
               for k, v in full.items()}
        step += 1
