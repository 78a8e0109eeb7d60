"""WeightDecoupler — asynchronous file retrieval + out-of-order
application support (paper Sec. III-C / III-D).

Weight loading has two phases:

  * **file retrieval** (I/O-bound): chunked extent read into host memory
    (pinned on a GPU host) + crc + deserialize to leaf views — runs on an
    I/O thread pool, *issued at request arrival* so it overlaps layer
    construction.  Each stream carries a suspension gate owned by the
    Priority-Aware Scheduler.
  * **weight application** (compute-bound): host-to-device copy +
    dequant/cast through the ``weight_transform`` kernel — performed by
    the Weight execution unit, *out of order*: any unit whose bytes and
    structure are both ready can be applied.

Retrieval here is unit-granular.  The reference's node-local
``WeightCache``, cluster ``ShardSource`` and shard-granular plans are
ROADMAP queue 1 items 6, 13 and 14.

In the PISeL baseline the two phases are fused and strictly ordered;
:meth:`WeightDecoupler.fetch_sync` provides that path.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.units import PipelineState
from repro_torch.store.store import Leaves, WeightStore


class WeightDecoupler:
    def __init__(self, store: WeightStore, model_name: str,
                 scheduler: PriorityAwareScheduler, trace: PipelineTrace,
                 state: PipelineState, *, io_workers: int = 4,
                 chunk_bytes: int = 1 << 20):
        """``state``: the run's PipelineState.  The decoupler shares its
        condition variable, so stream completions directly wake pipeline
        units blocked on that state, and puts stream errors there."""
        self.store = store
        self.model_name = model_name
        self.scheduler = scheduler
        self.trace = trace
        self.chunk_bytes = chunk_bytes
        self.io_workers = io_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self.state = state
        self.cv = state.cv
        self.ready: Dict[str, Leaves] = {}            # guarded-by: cv

    # ------------------------------------------------------ async retrieval
    def prefetch(self, units: List[str]):
        """Issue every retrieval stream now (at request arrival) — this is
        what lets retrieval overlap layer construction."""
        self._pool = ThreadPoolExecutor(max_workers=self.io_workers,
                                        thread_name_prefix="cicada-io")
        for u in units:
            nbytes = self.store.unit_nbytes(self.model_name, u)
            st = self.scheduler.register(u, nbytes)
            self._pool.submit(self._fetch, u, st)

    def _fetch(self, unit: str, st):
        try:
            self.scheduler.on_issue(unit)
            with self.cv:           # waiters recompute Algorithm 1 deadlines
                self.cv.notify_all()
            t0 = time.monotonic()
            raw = self.store.read_unit(self.model_name, unit,
                                       chunk_bytes=self.chunk_bytes,
                                       gate=st.gate)
            leaves = self.store.deserialize(self.model_name, unit, raw)
            self.trace.add_event("R", unit, t0, time.monotonic())
            self.scheduler.on_complete(unit)
            with self.cv:
                self.ready[unit] = leaves
                self.cv.notify_all()
        except BaseException as e:              # surfaced by the engine
            self.scheduler.on_error(unit)       # un-park suspended streams
            self.state.fail(e)

    # ------------------------------------------------------ sync (PISeL)
    def fetch_sync(self, unit: str) -> Leaves:
        """Blocking retrieval + deserialize — the fused W_i of PISeL."""
        raw = self.store.read_unit(self.model_name, unit,
                                   chunk_bytes=self.chunk_bytes)
        return self.store.deserialize(self.model_name, unit, raw)

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
