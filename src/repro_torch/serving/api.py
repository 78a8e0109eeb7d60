"""Public serving data model of the port: what to generate, and the
error a request that cannot fit the decode cache raises.

The reference's router types (``Request``, ``RequestClass``,
``Response``, pool and router stats, admission errors) come with the
serving platform (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class GenerateSpec:
    """One generation job: decode ``n_new`` tokens after ``prompt``.

    prompt       token ids, any 1-D sequence / array (or ``(1, S)``)
    n_new        tokens to generate (>= 1)
    temperature  0 -> greedy argmax; > 0 -> categorical sampling at
                 this temperature, keyed by ``seed`` and the absolute
                 token position (deterministic for a fixed seed,
                 independent of batching)
    max_len      per-request cap on total length (prompt + generated);
                 ``n_new`` is clamped down to honor it
    eos_id       stop early when this token is produced
    seed         per-request sampling key seed
    """
    prompt: Any
    n_new: int = 16
    temperature: float = 0.0
    max_len: Optional[int] = None
    eos_id: Optional[int] = None
    seed: int = 0


class CacheOverflowError(ValueError):
    """Raised when prompt + n_new cannot fit the decode KV cache
    (``cache_len``)."""
