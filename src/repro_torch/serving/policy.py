"""Keep-alive / eviction policies for instance pools (a port of
``repro.serving.policy``).

The serverless lifecycle (paper Fig. 2) reclaims idle instances after a
keep-alive window, re-triggering cold starts.  The rule is one policy
object the pool consults with the instance's idle time on whatever clock
the caller advances (trace replay uses the logical trace clock, a live
deployment would use wall time).
"""
from __future__ import annotations

import math
from typing import Optional


class EvictionPolicy:
    """Decides whether an *idle* instance should be reclaimed.  Busy or
    loading instances are never offered to the policy."""

    def should_evict(self, idle_s: float) -> bool:
        raise NotImplementedError


class KeepAliveTTL(EvictionPolicy):
    """Evict after ``ttl_s`` of idleness (strictly greater: an
    instance last used at ``last`` is evicted once ``last + ttl < now``).  ``ttl_s=0`` evicts as soon
    as the clock advances past the last use."""

    def __init__(self, ttl_s: float):
        if ttl_s < 0:
            raise ValueError("ttl_s must be >= 0")
        self.ttl_s = ttl_s

    def should_evict(self, idle_s: float) -> bool:
        return idle_s > self.ttl_s

    def __repr__(self):
        return f"KeepAliveTTL({self.ttl_s!r})"


class NeverEvict(EvictionPolicy):
    """Instances stay warm forever (provisioned-concurrency style)."""

    def should_evict(self, idle_s: float) -> bool:
        return False

    def __repr__(self):
        return "NeverEvict()"


def make_policy(keep_alive_s: Optional[float]) -> EvictionPolicy:
    """Shorthand: a TTL window, or never-evict for
    None / +inf."""
    if keep_alive_s is None or math.isinf(keep_alive_s):
        return NeverEvict()
    return KeepAliveTTL(keep_alive_s)
