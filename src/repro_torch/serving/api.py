"""Public serving data model of the port: requests, priority classes,
responses, the platform's stats and its typed errors (a port of
``repro.serving.api``).

The platform's front door is *generation-first*: cold-start latency is
time-to-first-token (TTFT), and steady-state throughput is decided by
batching.  The front door speaks four types:

  * :class:`GenerateSpec` — what to generate: prompt tokens, how many
    new tokens, greedy/temperature sampling, a per-request length cap
    and an optional EOS id;
  * :class:`Request` — one invocation of a deployed model function.
    ``gen`` makes it a generation request served by the instance's
    continuous-batching :class:`~repro_torch.serving.decode.DecodeScheduler`;
    the one-shot ``batch`` form (a single ``batch -> logits`` forward)
    is the degenerate ``n_new=0`` case;
  * :class:`RequestClass` — dispatch priority.  Lower value = served
    first.  The default classifier marks warm-servable work INFERENCE
    and cold starts COLDSTART: the Priority-Aware Scheduler's "inference
    first" rule at the routing layer;
  * :class:`Response` — the per-request record: cold/load_s/infer_s/
    utilization/latency, the queueing delay of concurrent admission, and
    for generation requests the emitted ``tokens`` with TTFT / per-token
    TPOT timings.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class RequestClass(enum.IntEnum):
    """Dispatch priority; lower value wins (inference-first rule)."""
    INFERENCE = 0          # warm steady-state forward
    COLDSTART = 1          # triggers the loading pipeline
    BACKGROUND = 2         # prefetch / maintenance work


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


@dataclasses.dataclass
class Request:
    """One invocation submitted to the Router."""
    req_id: int
    model: str
    batch: Optional[Dict[str, Any]] = None
    t_logical: float = 0.0          # trace arrival time (logical clock)
    cls: Optional[RequestClass] = None   # None -> classified at submit
    t_submit: float = 0.0           # wall clock, stamped by the Router
    gen: Optional[GenerateSpec] = None   # None -> one-shot logits request


@dataclasses.dataclass
class Response:
    req_id: int
    model: str
    cold: bool
    t_arrival: float
    t_done: float
    load_s: float           # cold-start pipeline time (0 for warm)
    infer_s: float          # steady-state inference time (warm requests)
    utilization: float      # pipeline utilization (cold requests)
    queue_s: float = 0.0    # admission -> service start (router queue +
                            # pool wait + instance provisioning)
    cls: RequestClass = RequestClass.INFERENCE
    # generation requests only (None for one-shot logits requests):
    tokens: Optional[Any] = None         # (n,) int array of emitted ids
    ttft_s: Optional[float] = None       # service start -> first token
    tpot_s: Optional[List[float]] = None  # inter-token intervals (n-1)
    node: Optional[str] = None           # serving node id (None on a
                                         # single-node platform)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def n_generated(self) -> int:
        return 0 if self.tokens is None else len(self.tokens)


class AdmissionError(RuntimeError):
    """Raised by Router.submit when admission control rejects a request
    (pending queue at capacity)."""


class UnknownModelError(KeyError):
    """Raised by Router.submit — on the submitting thread, not inside a
    worker — when a request names a model with no deployed pool."""


class CacheOverflowError(ValueError):
    """Raised when prompt + n_new cannot fit the decode KV cache
    (``cache_len``)."""


@dataclasses.dataclass
class PoolStats:
    """Point-in-time + cumulative counters for one InstancePool."""
    model: str
    size: int               # provisioned instances
    live: int               # instances holding params
    busy: int               # instances currently serving
    cold_starts: int
    warm_hits: int
    evictions: int
    gen_active: int = 0     # generation requests currently joined
    prewarms: int = 0       # pre-provisioned warm-ups (prewarm())


@dataclasses.dataclass
class RouterStats:
    submitted: int = 0
    rejected: int = 0
    completed: int = 0
    max_queue_depth: int = 0
    max_in_flight: int = 0
