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

Streams are unit-granular here: the reference's shard streams and
WeightCache-served streams come with those slices (ROADMAP queue 1
items 6 and 13).

Complexity matches the paper: O(n) over in-flight streams to suspend,
O(1) space per stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

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

    @property
    def completed(self) -> bool:
        return self.t_done is not None


class PriorityAwareScheduler:
    def __init__(self, *, bw_bytes_per_s: float = 1e9,
                 a_overhead_s: float = 1e-3, enabled: bool = True):
        self.enabled = enabled
        self._lock = analysis.make_lock("PriorityAwareScheduler._lock")
        self._streams: Dict[str, StreamState] = {}    # guarded-by: _lock
        # EMA of observed bandwidth
        self._bw = bw_bytes_per_s                     # guarded-by: _lock
        self._a = a_overhead_s
        # unit being prioritized
        self._critical: Optional[str] = None          # guarded-by: _lock
        self.suspend_count = 0                        # guarded-by: _lock

    # ------------------------------------------------------------- streams
    def register(self, unit: str, nbytes: int) -> StreamState:
        st = StreamState(unit, nbytes, threading.Event())
        st.gate.set()
        with self._lock:
            self._streams[unit] = st
        return st

    def on_issue(self, unit: str):
        with self._lock:
            self._streams[unit].t_issue = time.monotonic()

    def on_complete(self, unit: str):
        with self._lock:
            st = self._streams[unit]
            st.t_done = time.monotonic()
            dur = max(st.t_done - st.t_issue, 1e-9)
            self._bw = 0.7 * self._bw + 0.3 * st.nbytes / dur
            if self._critical == unit:
                self._critical = None
                for other in self._streams.values():
                    other.gate.set()       # resume suspended streams

    def on_error(self, unit: str):
        """A stream failed: mark it done and lift any suspension so no
        other reader stays parked on a cleared gate forever."""
        with self._lock:
            st = self._streams.get(unit)
            if st is not None and st.t_done is None:
                st.t_done = time.monotonic()
            self._critical = None
            for other in self._streams.values():
                other.gate.set()

    # ---------------------------------------------------------- Algorithm 1
    def _expected_completion_locked(self, st: StreamState) -> float:
        return (st.t_issue + self._a) + st.nbytes / max(self._bw, 1.0)

    def _in_flight_locked(self, unit: str) -> Optional[StreamState]:
        st = self._streams.get(unit)
        if st is None or st.completed or st.t_issue == 0.0:
            return None
        return st

    def time_until_expected(self, unit: str) -> Optional[float]:
        """Seconds until *unit*'s expected completion — the wake-up
        deadline an event-driven waiter arms to run Algorithm 1 at
        exactly the right moment.  None = no deadline applies (scheduler
        disabled, unit unknown / not issued yet / completed, or the unit
        is already the prioritized critical one)."""
        if not self.enabled:
            return None
        with self._lock:
            st = self._in_flight_locked(unit)
            if self._critical == unit or st is None:
                return None
            return max(0.0, self._expected_completion_locked(st)
                       - time.monotonic())

    def adjust_priority(self, unit: str) -> str:
        """Algorithm 1: called for the layer the pipeline needs next.

        If W_unit is past its expected completion and still running,
        suspend every other in-flight stream and mark the unit HIGH.
        """
        if not self.enabled:
            return NORMAL
        now = time.monotonic()
        with self._lock:
            st = self._in_flight_locked(unit)
            if st is None or now < self._expected_completion_locked(st):
                return NORMAL
            for other in self._streams.values():            # O(n)
                if other.unit != unit and not other.completed:
                    other.gate.clear()                      # block W
                    self.suspend_count += 1
            st.gate.set()
            self._critical = unit
            return HIGH
