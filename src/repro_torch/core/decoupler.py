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

With a node-local :class:`~repro_torch.store.cache.WeightCache` attached,
every stream consults the cache before issuing I/O: a hit publishes its
leaves immediately (a ~zero-cost R trace event marked ``cached``), a miss
single-flights the store read node-wide.  Cached entries stay pinned from
retrieval until weight application (released by :meth:`checkin`), so
eviction pressure never reclaims leaves an in-flight — possibly
Algorithm-1-critical — load is about to apply.

A miss reads its bytes through a :class:`ShardSource`: by default the
origin store, or with ``source=`` a cluster's peer-exchange tier
(:class:`~repro_torch.cluster.peer.ClusterShardSource`), which serves the
payload from a peer node's cache over the intra-cluster link and falls
back to the origin read only when this node is the cluster-wide leader
for the unit.  Retrieval here is unit-granular (shard key 0); the
reference's shard-granular plans are ROADMAP queue 1 item 13.

In the PISeL baseline the two phases are fused and strictly ordered;
:meth:`WeightDecoupler.fetch_sync` provides that path.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from repro_torch import analysis
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.units import PipelineState
from repro_torch.store.cache import LOAD, WeightCache
from repro_torch.store.store import Leaves, WeightStore


class ShardSource:
    """Where a stream's bytes come from when the local cache misses.

    The default source is the origin store: :meth:`fetch` just invokes
    the ``read_origin`` thunk the decoupler hands it.  The cluster tier
    (``repro_torch.cluster.peer.ClusterShardSource``) overrides it to
    consult a cluster-wide placement table first and serve the payload
    from a peer node's cache over the intra-cluster link; the origin
    thunk then runs only when this node is elected the cluster-wide
    single-flight leader for the key.

    Contract with the decoupler (it mirrors the WeightCache protocol):
    ``fetch`` returns ``(payload, src)`` with ``src`` in {"origin",
    "peer"}; after the payload is published to the local cache the
    decoupler calls :meth:`publish`, and on any failure between fetch
    and publish it calls :meth:`abort` (both no-ops here)."""

    def fetch(self, model: str, unit: str, skey: Hashable, nbytes: int,
              read_origin: Callable[[], Any], *,
              gate=None, on_chunk: Optional[Callable[[int], None]] = None
              ) -> Tuple[Any, str]:
        return read_origin(), "origin"

    def publish(self, model: str, unit: str, skey: Hashable):
        pass

    def abort(self, model: str, unit: str, skey: Hashable):
        pass


class WeightDecoupler:
    def __init__(self, store: WeightStore, model_name: str,
                 scheduler: PriorityAwareScheduler, trace: PipelineTrace,
                 state: PipelineState, *, io_workers: int = 4,
                 chunk_bytes: int = 1 << 20,
                 cache: Optional[WeightCache] = None,
                 source: Optional[ShardSource] = None):
        """``state``: the run's PipelineState.  The decoupler shares its
        condition variable, so stream completions directly wake pipeline
        units blocked on that state, and puts stream errors there.

        ``cache``: optional node-local WeightCache consulted before any
        I/O is issued (shared across engines/instances for scale-out
        reuse and single-flight reads).

        ``source``: where a local-cache miss reads its bytes (see
        :class:`ShardSource`).  Requires a cache: the source's publish
        step is what makes this node's resident copy visible to peers,
        and peers are served from that cache."""
        if source is not None and cache is None:
            raise ValueError("a ShardSource requires a WeightCache "
                             "(peers are served from this node's cache)")
        self.store = store
        self.model_name = model_name
        self.scheduler = scheduler
        self.trace = trace
        self.chunk_bytes = chunk_bytes
        self.io_workers = io_workers
        self.cache = cache
        self.source = source
        self._pool: Optional[ThreadPoolExecutor] = None
        self.state = state
        # the run's condition variable, borrowed; the factory call names
        # it a lock for the concurrency lint (as the reference's does)
        self.cv = state.cv if state is not None \
            else analysis.make_condition("WeightDecoupler.cv")
        self.ready: Dict[str, Leaves] = {}            # guarded-by: cv
        self._pinned: set = set()                     # guarded-by: cv
        self._load_registered = False
        self._closed = False                          # guarded-by: cv

    # ------------------------------------------------------ async retrieval
    def prefetch(self, units: List[str]):
        """Issue every retrieval stream now (at request arrival) — this is
        what lets retrieval overlap layer construction."""
        if self.cache is not None and not self._load_registered:
            self.cache.register_load(self.model_name)
            self._load_registered = True
        self._pool = ThreadPoolExecutor(max_workers=self.io_workers,
                                        thread_name_prefix="cicada-io")
        for u in units:
            nbytes = self.store.unit_nbytes(self.model_name, u)
            st = self.scheduler.register(u, nbytes)
            self._pool.submit(self._fetch, u, st)

    @staticmethod
    def _src_meta(src: str) -> Optional[Dict[str, Any]]:
        """Trace annotation of a stream's byte source: origin reads are
        unmarked, cache hits carry ``cached``, peer-exchange transfers
        carry ``peer``."""
        if src == "cache":
            return {"cached": True}
        if src == "peer":
            return {"peer": True}
        return None

    def _progress_cb(self, unit: str, total: int) -> Callable[[int], None]:
        """Per-chunk progress callback of a source-driven transfer (the
        peer link): accumulates into the scheduler's stream state as
        :meth:`_read_store` does for origin reads."""
        done = [0]
        t = max(1, int(total))

        def cb(n: int):
            done[0] += n
            self.scheduler.on_progress(unit, done[0], t)
        return cb

    def _fetch(self, unit: str, st):
        try:
            self.scheduler.on_issue(unit)
            with self.cv:           # waiters recompute Algorithm 1 deadlines
                self.cv.notify_all()
            t0 = time.monotonic()
            leaves, src = self._retrieve(unit, st)
            self.trace.add_event("R", unit, t0, time.monotonic(),
                                 meta=self._src_meta(src))
            self.scheduler.on_complete(unit, observed=(src == "origin"))
            with self.cv:
                self.ready[unit] = leaves
                self.cv.notify_all()
        except BaseException as e:              # surfaced by the engine
            self.scheduler.on_error(unit)       # un-park suspended streams
            self.state.fail(e)

    def _retrieve(self, unit: str, st) -> Tuple[Leaves, str]:
        """One stream's leaves: cache hit / single-flight wait / leader
        read through the source (the origin store, or a cluster peer's
        cache over the intra-cluster link).  Returns ``(leaves, src)``
        with src in {"cache", "origin", "peer"}."""
        if self.cache is None:
            return self._read_store(unit, st), "origin"
        # A hit OR a wait on another load's read is external to this
        # pipeline's I/O: Algorithm 1 must not prioritize it (see
        # PriorityAwareScheduler.mark_external).  Which one it is shows
        # only after begin() returns, so flag first and unflag only when
        # this stream turns out to run a genuine origin read.  A peer
        # transfer stays external too: suspending local streams cannot
        # speed up another node's cache.
        self.scheduler.mark_external(unit)
        status, leaves = self.cache.begin(self.model_name, unit)
        if status == LOAD:
            def read_origin():
                self.scheduler.mark_external(unit, False)
                return self._read_store(unit, st)
            src = "origin"
            try:
                if self.source is None:
                    leaves = read_origin()
                else:
                    leaves, src = self.source.fetch(
                        self.model_name, unit, 0, st.nbytes, read_origin,
                        gate=st.gate,
                        on_chunk=self._progress_cb(unit, st.nbytes))
                self.cache.complete(self.model_name, unit, leaves,
                                    st.nbytes)
            except BaseException:
                self.cache.abort(self.model_name, unit)
                if self.source is not None:
                    self.source.abort(self.model_name, unit, 0)
                raise
            if self.source is not None:
                self.source.publish(self.model_name, unit, 0)
            self._pin(unit)
            return leaves, src
        self._pin(unit)
        return leaves, "cache"

    def _read_store(self, unit: str, st) -> Leaves:
        raw = self.store.read_unit(
            self.model_name, unit, chunk_bytes=self.chunk_bytes,
            gate=st.gate,
            on_progress=lambda d, t: self.scheduler.on_progress(unit, d, t))
        return self.store.deserialize(self.model_name, unit, raw)

    # ------------------------------------------------------ cache bookkeeping
    def _pin(self, unit: str):
        with self.cv:
            if not self._closed:
                self._pinned.add(unit)
                return
        # shutdown already swept pins: release straight away
        self.cache.release(self.model_name, unit)

    def checkin(self, unit: str):
        """Weight application of ``unit`` is done: drop its cache pin
        (no-op without a cache)."""
        if self.cache is None:
            return
        with self.cv:
            if unit not in self._pinned:
                return
            self._pinned.discard(unit)
        self.cache.release(self.model_name, unit)

    # ------------------------------------------------------ sync (PISeL)
    def fetch_sync(self, unit: str) -> Leaves:
        """Blocking retrieval + deserialize — the fused W_i of PISeL."""
        raw = self.store.read_unit(self.model_name, unit,
                                   chunk_bytes=self.chunk_bytes)
        return self.store.deserialize(self.model_name, unit, raw)

    def shutdown(self):
        """Stop the I/O pool and, with a cache, release the pins an
        aborted load left and retire the load's in-flight registration —
        on the failure path too."""
        with self.cv:
            # _closed flips under cv so a stream finishing its read sees
            # it, or the sweep below sees that stream's pin — never neither
            self._closed = True
            pinned, self._pinned = self._pinned, set()
            self.cv.notify_all()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self.cache is not None:
            for u in pinned:                 # pins left by an aborted load
                self.cache.release(self.model_name, u)
            if self._load_registered:
                self._load_registered = False
                self.cache.unregister_load(self.model_name)
