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
for the key.

With a shard plan (``plan_fn=``, given by an engine with a mesh),
retrieval is **shard-granular**: every unit fans out into one stream per
mesh device (a :class:`~repro_torch.core.shards.UnitShardPlan`), each
reading only the byte ranges of the leaf slices its device owns, on its
own simulated-device channel, and cached under ``(model, unit,
(mesh_tag, shard))``.  Streams complete out of order across shards, not
just units: a landed shard goes at once to a placement lane (one of
``min(4, shards)`` threads, each with its own CUDA stream), which copies
its pieces to the device, runs ``weight_transform`` on the transformed
ones and commits them (:meth:`ShardedUnitData.add_shard`), and
``ready[unit]`` publishes when the unit's **last** shard has been placed.
Without a plan the unit-granular path (shard key 0) is unchanged.

In the PISeL baseline the two phases are fused and strictly ordered;
:meth:`WeightDecoupler.fetch_sync` provides that path.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch import analysis
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.shards import ShardedUnitData, UnitShardPlan
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
                 source: Optional[ShardSource] = None,
                 plan_fn: Optional[Callable[[str], UnitShardPlan]] = None):
        """``state``: the run's PipelineState.  The decoupler shares its
        condition variable, so stream completions directly wake pipeline
        units blocked on that state, and puts stream errors there.

        ``cache``: optional node-local WeightCache consulted before any
        I/O is issued (shared across engines/instances for scale-out
        reuse and single-flight reads).

        ``source``: where a local-cache miss reads its bytes (see
        :class:`ShardSource`).  Requires a cache: the source's publish
        step is what makes this node's resident copy visible to peers,
        and peers are served from that cache.

        ``plan_fn``: unit -> UnitShardPlan — enables shard-granular
        retrieval (the engine supplies plans resolved from its mesh and
        sharding rules).  None keeps unit-granular streams."""
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
        self.plan_fn = plan_fn
        self._plans: Dict[str, UnitShardPlan] = {}
        self._mesh_tag: Optional[str] = None
        # Created at prefetch, sized to the stream count: a suspended
        # stream parks INSIDE its worker (gate.wait mid-read), so a pool
        # smaller than the stream fan-out can wedge.
        self._pool: Optional[ThreadPoolExecutor] = None
        self._committer: Optional[ThreadPoolExecutor] = None
        self._lanes = threading.local()    # each lane thread's CUDA stream
        # unit -> its shard streams, submitted when the unit is admitted
        self._waiting: Dict[str, List[Tuple]] = {}    # guarded-by: cv
        self.state = state
        # the run's condition variable, borrowed; the factory call names
        # it a lock for the concurrency lint (as the reference's does)
        self.cv = state.cv if state is not None \
            else analysis.make_condition("WeightDecoupler.cv")
        self._unadmitted: List[str] = []              # guarded-by: cv
        self._reads_left: Dict[str, int] = {}         # guarded-by: cv
        # unit -> Leaves (unit-granular) | ShardedUnitData (complete)
        self.ready: Dict[str, Any] = {}               # guarded-by: cv
        # (unit, shard key) cache pins
        self._pinned: set = set()                     # guarded-by: cv
        self._load_registered = False
        self._closed = False                          # guarded-by: cv

    # ------------------------------------------------------ async retrieval
    def prefetch(self, units: List[str]):
        """Issue every retrieval stream now (at request arrival) — this is
        what lets retrieval overlap layer construction.  With a shard
        plan, that is ``n_units x n_shards`` independent streams."""
        if self.cache is not None and not self._load_registered:
            self.cache.register_load(self.model_name)
            self._load_registered = True
        if self.plan_fn is None:
            self._pool = ThreadPoolExecutor(max_workers=self.io_workers,
                                            thread_name_prefix="cicada-io")
            for u in units:
                nbytes = self.store.unit_nbytes(self.model_name, u)
                st = self.scheduler.register(u, nbytes)
                self._pool.submit(self._fetch, u, st)
            return
        # Unit admission window: only ``io_workers`` units' shard streams
        # read concurrently, admitted in pipeline order and advanced as
        # units finish.  With every stream admitted at once they would
        # fair-share the channels and ALL units would land near the end
        # of the load — no early unit for the pipeline to apply and
        # execute against.  A unit's streams are submitted when it is
        # admitted, so the pool holds every admitted stream at once (a
        # suspended stream parks inside its worker) and no idle waiter.
        width = min(self.io_workers, len(units))
        # pre-thread initialization: the stream workers that share cv
        # are submitted only at the end of this method
        self._unadmitted = list(units)      # analysis: ignore[R1]
        self._reads_left = {}               # analysis: ignore[R1]
        self._waiting = {}                  # analysis: ignore[R1]
        for u in units:
            plan = self.plan_fn(u)
            self._plans[u] = plan
            data = ShardedUnitData(plan, trace=self.trace)
            if self._mesh_tag is None:
                self._mesh_tag = plan.tag
            self._reads_left[u] = plan.n_shards     # analysis: ignore[R1]
            self._waiting[u] = [                    # analysis: ignore[R1]
                (u, s, self.scheduler.register(u, plan.shard_nbytes(s),
                                               shard=s), data)
                for s in range(plan.n_shards)]
        shards = max(p.n_shards for p in self._plans.values())
        self._pool = ThreadPoolExecutor(
            max_workers=max(self.io_workers, width * shards),
            thread_name_prefix="cicada-io")
        # placement lanes — the modeled per-device DMA queues: host
        # merges, copies, transforms and commits run here instead of on
        # the read threads, and still start the moment each shard lands
        self._committer = ThreadPoolExecutor(
            max_workers=min(4, shards), thread_name_prefix="cicada-commit")
        with self.cv:
            for _ in range(width):
                self._admit_next_locked()

    def _admit_next_locked(self):
        """Admit the next unit in pipeline order: submit its shard
        streams (cv held, so that shutdown sees either the submission or
        no admission at all)."""
        if self._closed or not self._unadmitted:
            return
        unit = self._unadmitted.pop(0)
        for stream in self._waiting.pop(unit):
            self._pool.submit(self._fetch_shard, *stream)

    @staticmethod
    def _src_meta(src: str, meta: Optional[Dict[str, Any]] = None
                  ) -> Optional[Dict[str, Any]]:
        """Trace annotation of a stream's byte source: origin reads are
        unmarked, cache hits carry ``cached``, peer-exchange transfers
        carry ``peer``."""
        if src == "cache":
            meta = dict(meta or (), cached=True)
        elif src == "peer":
            meta = dict(meta or (), peer=True)
        return meta

    def _progress_cb(self, unit: str, total: int, shard: Hashable = 0
                     ) -> Callable[[int], None]:
        """Per-chunk progress callback of a source-driven transfer (the
        peer link): accumulates into the scheduler's stream state as
        :meth:`_read_store` and :meth:`_read_shard` do for origin
        reads."""
        done = [0]
        t = max(1, int(total))

        def cb(n: int):
            done[0] += n
            self.scheduler.on_progress(unit, done[0], t, shard=shard)
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
            self._pin(unit, 0)
            return leaves, src
        self._pin(unit, 0)
        return leaves, "cache"

    def _read_store(self, unit: str, st) -> Leaves:
        raw = self.store.read_unit(
            self.model_name, unit, chunk_bytes=self.chunk_bytes,
            gate=st.gate,
            on_progress=lambda d, t: self.scheduler.on_progress(unit, d, t))
        return self.store.deserialize(self.model_name, unit, raw)

    # ------------------------------------------------- shard-granular path
    def _shard_key(self, shard: int) -> Hashable:
        # cache identity: the same unit planned for a different mesh
        # shape OR different sharding rules holds different byte ranges —
        # never serve one as the other (the tag fingerprints both; see
        # shards.plan_tag)
        return (self._mesh_tag, shard)

    def _fetch_shard(self, unit: str, shard: int, st,
                     data: ShardedUnitData):
        try:
            with self.cv:
                if self._closed:            # the load was shut down
                    return
            self.scheduler.on_issue(unit, shard=shard)
            with self.cv:
                self.cv.notify_all()
            t0 = time.monotonic()
            payload, src = self._retrieve_shard(unit, shard, st, data)
            self.trace.add_event("R", unit, t0, time.monotonic(),
                                 meta=self._src_meta(src, {"shard": shard}))
            self.scheduler.on_complete(unit, observed=(src == "origin"),
                                       shard=shard)
            with self.cv:                   # unit fully read: admit next
                self._reads_left[unit] -= 1
                if self._reads_left[unit] == 0:
                    self._admit_next_locked()
            # placement runs on a lane the moment the shard lands — out
            # of order across shards, no sibling barrier
            self._committer.submit(self._commit_shard, unit, shard, data,
                                   payload, self.cache is None)
        except BaseException as e:
            self.scheduler.on_error(unit, shard=shard)
            self.state.fail(e)

    def _lane_stream(self, device: torch.device):
        """This placement lane's own CUDA stream (made on first use)."""
        stream = getattr(self._lanes, "stream", None)
        if stream is None:
            stream = self._lanes.stream = torch.cuda.Stream(device)
        return stream

    def _commit_shard(self, unit: str, shard: int, data: ShardedUnitData,
                      payload, merged: bool):
        try:
            # host merge (cache path only), the per-shard weight_transform
            # of dequant/cast pieces and the commit, on the lane's
            # stream; exactly one lane — the unit-completing one, after
            # the unit's ready event is recorded — gets last=True
            dev = data.device
            if dev.type == "cuda":
                with torch.cuda.stream(self._lane_stream(dev)):
                    last = data.add_shard(shard, payload, merged=merged)
            else:
                last = data.add_shard(shard, payload, merged=merged)
            with self.cv:
                if last:
                    self.ready[unit] = data
                self.cv.notify_all()
        except BaseException as e:
            self.state.fail(e)

    def _retrieve_shard(self, unit: str, shard: int, st,
                        data: ShardedUnitData):
        skey = self._shard_key(shard)
        if self.cache is None:
            # no cache: late leaves gather straight into their full host
            # tensors (the cache path keeps standalone slices — its
            # payloads outlive this load)
            return self._read_shard(unit, shard, st, data), "origin"
        self.scheduler.mark_external(unit, shard=shard)
        status, payload = self.cache.begin(self.model_name, unit, skey)
        if status == LOAD:
            def read_origin():
                self.scheduler.mark_external(unit, False, shard=shard)
                return self._read_shard(unit, shard, st)
            src = "origin"
            try:
                if self.source is None:
                    payload = read_origin()
                else:
                    payload, src = self.source.fetch(
                        self.model_name, unit, skey, st.nbytes,
                        read_origin, gate=st.gate,
                        on_chunk=self._progress_cb(unit, st.nbytes, shard))
                self.cache.complete(self.model_name, unit, payload,
                                    st.nbytes, skey)
            except BaseException:
                self.cache.abort(self.model_name, unit, skey)
                if self.source is not None:
                    self.source.abort(self.model_name, unit, skey)
                raise
            if self.source is not None:
                self.source.publish(self.model_name, unit, skey)
            self._pin(unit, skey)
            return payload, src
        self._pin(unit, skey)
        return payload, "cache"

    def _read_shard(self, unit: str, shard: int, st,
                    data: Optional[ShardedUnitData] = None):
        """One shard stream: byte-range reads of every leaf slice this
        shard owns, over the shard's own simulated-device channel.

        With ``data`` a late leaf's slice is gathered straight into the
        leaf's full host tensor (:meth:`ShardedUnitData.host_dest`);
        every other slice, and every slice on the cache path, into a
        contiguous tensor of its own."""
        plan = self._plans[unit]
        total = max(1, plan.shard_nbytes(shard))
        done = [0]

        def on_chunk(n: int):
            done[0] += n
            self.scheduler.on_progress(unit, done[0], total, shard=shard)

        payload = []
        with self.store.open_unit(self.model_name, unit) as fh:
            for piece in plan.pieces[shard]:
                out = None
                if data is not None and piece.index is not None:
                    out = data.host_dest(piece.leaf, piece.index)
                arr, scale = self.store.read_leaf_slice(
                    self.model_name, unit, piece.leaf, piece.index,
                    fh=fh, chunk_bytes=self.chunk_bytes, gate=st.gate,
                    on_chunk=on_chunk, channel=shard, out=out)
                payload.append((piece.leaf, arr, scale, piece.index))
        return payload

    def trace_transforms(self):
        """Put the placement lanes' ``T`` events, timed on the card, on
        the trace; call once the load has synchronized the device."""
        with self.cv:
            done = [d for d in self.ready.values()
                    if isinstance(d, ShardedUnitData)]
        for data in done:
            data.trace_transforms()

    # ------------------------------------------------------ cache bookkeeping
    def _pin(self, unit: str, skey: Hashable):
        with self.cv:
            if not self._closed:
                self._pinned.add((unit, skey))
                return
        # shutdown already swept pins: release straight away
        self.cache.release(self.model_name, unit, skey)

    def checkin(self, unit: str):
        """Weight application of ``unit`` is done: drop the load's hold on
        its retrieved host leaves, so that a load keeps about
        ``io_workers`` units' bytes on the host and not the whole model's
        (a sharded unit's device data stays for :meth:`trace_transforms`;
        the unit stays in ``ready``), and the cache pins of all its
        shards (no-op without a cache)."""
        with self.cv:
            if not isinstance(self.ready.get(unit), ShardedUnitData):
                self.ready[unit] = None
        if self.cache is None:
            return
        with self.cv:
            mine = [(u, k) for (u, k) in self._pinned if u == unit]
            self._pinned.difference_update(mine)
        for u, k in mine:
            self.cache.release(self.model_name, u, k)

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
        if self._committer is not None:
            self._committer.shutdown(wait=False)
        if self.cache is not None:
            for u, k in pinned:              # pins left by an aborted load
                self.cache.release(self.model_name, u, k)
            if self._load_registered:
                self._load_registered = False
                self.cache.unregister_load(self.model_name)
