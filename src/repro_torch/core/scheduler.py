"""Priority-Aware Scheduler (paper Sec. III-E, Algorithm 1).

Asynchronous retrieval completes in unpredictable order; if layer L_i's
structure is ready but its weight file W_i is *late* — past its expected
completion time ``(t_issue + a) + D_{W_i}`` — every other in-flight
retrieval stream is suspended (cooperative gates cleared) so W_i gets
the full I/O bandwidth.  Streams resume when W_i completes.

Expected durations D_W are size-based: ``nbytes / bw_estimate`` with an
EMA of observed stream bandwidth (the paper's "records the execution
times of each ... weight file (W) operation").  ``a`` is the measured
pipeline-unit scheduling overhead.

A stream served by the node-local WeightCache (a hit, or a wait on
another load's read) is *external*: it is never prioritized, arms no
deadline, and its ~zero duration is not folded into the bandwidth EMA.

Under shard-granular cold starts one layer unit is retrieved by several
concurrent *shard streams* (one per mesh device, each on its own
simulated-device channel).  Streams register as ``(unit, shard)``;
Algorithm 1 still reasons about *units* — the pipeline needs unit i's
weights, which land when its **last** shard lands — so a unit's expected
completion is the max over its in-flight shard streams, and prioritizing
a late unit suspends every stream of every *other* unit (its own shards
keep all their channels).  Unit-granular streams are shard 0.

Complexity matches the paper: O(n) over in-flight streams to suspend,
O(1) space per stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Hashable, Optional, Tuple

from repro_torch import analysis

HIGH = "HIGH"
NORMAL = "NORMAL"


@dataclasses.dataclass
class StreamState:
    unit: str
    nbytes: int
    gate: threading.Event                 # set = may run; cleared = suspended
    t_issue: float = 0.0
    t_done: Optional[float] = None
    bytes_done: int = 0
    external: bool = False                # served by the WeightCache, not
                                          # a local store read
    shard: Hashable = 0                   # ((unit, shard) is the key)

    @property
    def completed(self) -> bool:
        return self.t_done is not None


class PriorityAwareScheduler:
    def __init__(self, *, bw_bytes_per_s: float = 1e9,
                 a_overhead_s: float = 1e-3, enabled: bool = True):
        self.enabled = enabled
        self._lock = analysis.make_lock("PriorityAwareScheduler._lock")
        self._streams: Dict[Tuple[str, Hashable], StreamState] = {}  # guarded-by: _lock
        # EMA of observed bandwidth
        self._bw = bw_bytes_per_s                     # guarded-by: _lock
        self._a = a_overhead_s
        # unit being prioritized
        self._critical: Optional[str] = None          # guarded-by: _lock
        self.suspend_count = 0                        # guarded-by: _lock

    # ------------------------------------------------------------- streams
    def register(self, unit: str, nbytes: int, shard: Hashable = 0
                 ) -> StreamState:
        st = StreamState(unit, nbytes, threading.Event(), shard=shard)
        st.gate.set()
        with self._lock:
            self._streams[(unit, shard)] = st
        return st

    def on_issue(self, unit: str, shard: Hashable = 0):
        with self._lock:
            self._streams[(unit, shard)].t_issue = time.monotonic()

    def on_progress(self, unit: str, done: int, total: int,
                    shard: Hashable = 0):
        with self._lock:
            self._streams[(unit, shard)].bytes_done = done

    def mark_external(self, unit: str, external: bool = True,
                      shard: Hashable = 0):
        """The stream is being served by the node-local WeightCache (a
        hit, or a wait on another load's read): it is not a local store
        read, so Algorithm 1 must neither prioritize it (suspending
        local streams cannot speed it up — and doing so across two
        concurrent loads that lead each other's units would deadlock)
        nor arm a bandwidth-based deadline for it."""
        with self._lock:
            self._streams[(unit, shard)].external = external

    def on_complete(self, unit: str, *, observed: bool = True,
                    shard: Hashable = 0):
        """``observed=False``: the stream finished without a store read
        (cache hit) — complete it without folding the ~zero duration
        into the bandwidth EMA.  A prioritized unit releases the others'
        gates when its last stream completes."""
        with self._lock:
            st = self._streams[(unit, shard)]
            st.t_done = time.monotonic()
            if observed:
                dur = max(st.t_done - st.t_issue, 1e-9)
                self._bw = 0.7 * self._bw + 0.3 * st.nbytes / dur
            if self._critical == unit and self._unit_done_locked(unit):
                self._critical = None
                for other in self._streams.values():
                    other.gate.set()       # resume suspended streams

    def on_error(self, unit: str, shard: Hashable = 0):
        """A stream failed: mark it done and lift any suspension so no
        other reader stays parked on a cleared gate forever."""
        with self._lock:
            st = self._streams.get((unit, shard))
            if st is not None and st.t_done is None:
                st.t_done = time.monotonic()
            self._critical = None
            for other in self._streams.values():
                other.gate.set()

    # ---------------------------------------------------------- Algorithm 1
    def _unit_done_locked(self, unit: str) -> bool:
        return all(st.completed for st in self._streams.values()
                   if st.unit == unit)

    def _expected_completion_locked(self, st: StreamState) -> float:
        return (st.t_issue + self._a) + st.nbytes / max(self._bw, 1.0)

    def _in_flight_locked(self, unit: str):
        """The unit's issued, incomplete streams that read the store."""
        return [st for st in self._streams.values()
                if st.unit == unit and not st.completed
                and st.t_issue != 0.0 and not st.external]

    def expected_completion(self, unit: str, shard: Hashable = 0) -> float:
        with self._lock:
            return self._expected_completion_locked(
                self._streams[(unit, shard)])

    def time_until_expected(self, unit: str) -> Optional[float]:
        """Seconds until *unit*'s expected completion — the wake-up
        deadline an event-driven waiter arms to run Algorithm 1 at
        exactly the right moment.  A sharded unit completes when its last
        shard lands, so this is the max over its in-flight shard streams.
        None = no deadline applies (scheduler disabled, unit unknown /
        not issued yet / completed / served by the cache, or the unit is
        already the prioritized critical one)."""
        if not self.enabled:
            return None
        with self._lock:
            live = self._in_flight_locked(unit)
            if self._critical == unit or not live:
                return None
            exp = max(self._expected_completion_locked(st) for st in live)
            return max(0.0, exp - time.monotonic())

    def adjust_priority(self, unit: str) -> str:
        """Algorithm 1: called for the layer the pipeline needs next.

        If any of W_unit's streams is past its expected completion and
        still running (a local read, not an external one), suspend every
        other unit's in-flight streams and mark the unit HIGH (all of its
        own shards keep their channels).
        """
        if not self.enabled:
            return NORMAL
        now = time.monotonic()
        with self._lock:
            if not any(now >= self._expected_completion_locked(st)
                       for st in self._in_flight_locked(unit)):
                return NORMAL
            for other in self._streams.values():            # O(n)
                if other.unit != unit and not other.completed:
                    other.gate.clear()                      # block W
                    self.suspend_count += 1
            for own in self._streams.values():
                if own.unit == unit:
                    own.gate.set()
            self._critical = unit
            return HIGH

    def stats(self) -> dict:
        with self._lock:
            return {"bw_estimate": self._bw,
                    "suspends": self.suspend_count,
                    "streams": len(self._streams)}
