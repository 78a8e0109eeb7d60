"""Shard-granular retrieval plans: (layer-unit, shard) is the unit of
pipelined work (a port of ``repro.core.shards``).

λScale and HydraServe/ParaServe show that parallelizing the *load* across
devices is the dominant lever for serverless LLM cold starts.  A
:class:`UnitShardPlan` splits one layer unit's weight extent into one
retrieval stream per mesh device, each stream reading only the byte
ranges of the leaf slices its device owns (``WeightStore.
read_leaf_slice``).  Streams are independent: they draw from separate
simulated-device channels, carry their own Priority-Aware-Scheduler gates
and deadlines, and are cached per ``(model, unit, (mesh_tag, shard))``.

Placement is *eager*: the moment a shard stream lands, its placement lane
(:meth:`ShardedUnitData.add_shard`) copies each piece host-to-device on
the lane's own CUDA stream and commits it into its slice of **one
allocation per leaf** on the physical device; leaves the apply path
*transforms* — int8 (per-column scales at the tail of the payload) and
floating leaves under an ``apply_dtype`` cast — first run the
``weight_transform`` kernel on the piece, so the weight-application
compute phase is pipelined per shard.  Bit-identity with the whole-read
path holds because the transform is elementwise: the transform of a
slice is the slice of the transform.

Every device of a port mesh is a logical device on one physical device
(:mod:`repro_torch.launch.mesh`), so the per-leaf allocation *is* the
steady-state leaf, which every logical device's slice of it shares: no
stitch is needed, and the pipeline's compute units, the assembled params
and the warm forward read the committed bytes.  The reference copies
transformed pieces back to the host and ships them out again for
compute, because its placement devices and its default device differ;
here a transformed piece is written once, on the card.  A mesh over
several cards will need the stitch.

Ordering on the card: the buffers that several lanes write are allocated
before the lanes start, and each lane waits on the allocation's event
before it writes.  Each shard's lane records a CUDA event after its
copies and kernels and never waits for them; the lane that lands a
unit's last shard makes its stream wait on every other shard's event,
places the leaves that commit late (below ``COMMIT_FLOOR_BYTES``) and
records the unit's ready event, which the weight unit waits on before
any reader touches the leaves.

Leaves whose resolved spec is replication (including an axis that does
not divide its dimension — ``_guarded_spec``'s fallback) are read whole
by exactly one stream, round-robined across shards for balance.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import analysis
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              ShardingRules, leaf_specs)
from repro_torch.kernels import ops
from repro_torch.store.store import _DTYPES, slice_byte_runs

# Shard slices whose contiguous runs would fall below this floor are
# read whole by one stream instead (still *committed* sharded): a
# strided sub-KB run pattern pays more in seeks than parallel links
# save.  Real deployments with head-sharded attention leaves stay well
# above it (32 heads x 128 dims x 4B = 16 KiB runs).
RUN_FLOOR_BYTES = 1024

# Leaves below this per-device size skip the eager in-stream commit and
# are placed when the unit's last shard lands: the per-copy overhead of
# committing dozens of small buffers from the lanes costs more than the
# overlap saves.  The heavy leaves (embeddings, FFN matrices) — where
# overlap matters — are far above it.
COMMIT_FLOOR_BYTES = 256 * 1024

Index = Tuple[Any, ...]          # per-dim slices into a leaf
# one retrieved piece: (leaf, tensor, scale_or_None, index_or_None)
ShardPayload = List[Tuple[str, torch.Tensor, Optional[torch.Tensor],
                          Optional[Index]]]


@dataclasses.dataclass
class LeafPiece:
    """One shard stream's share of one leaf."""
    leaf: str
    index: Optional[Index]       # None -> whole payload (replicated/floor)
    nbytes: int                  # bytes this stream reads for the piece
    devices: Tuple[Any, ...]     # the logical devices it commits to


@dataclasses.dataclass
class UnitShardPlan:
    """Static per-(model, unit) retrieval plan for a mesh."""
    unit: str
    mesh: Mesh
    specs: Dict[str, NamedSharding]        # leaf -> NamedSharding
    pieces: List[List[LeafPiece]]          # per shard
    shapes: Dict[str, Tuple[int, ...]]     # leaf -> full shape
    dtypes: Dict[str, str]                 # leaf -> stored dtype
    quant: Dict[str, bool]                 # leaf -> int8-stored
    commit: Dict[str, bool]                # leaf -> eager commit per piece
    transformed: Dict[str, bool]           # leaf -> dequant/cast at apply
    out_dtype: Dict[str, Optional[torch.dtype]]  # transform target
    tag: str                               # mesh-shape + rules fingerprint

    @property
    def n_shards(self) -> int:
        return len(self.pieces)

    def shard_nbytes(self, shard: int) -> int:
        return sum(p.nbytes for p in self.pieces[shard])

    def n_transformed(self, shard: Optional[int] = None) -> int:
        """Transformed pieces of one shard (of all shards: None) — one
        ``weight_transform`` launch each."""
        shards = range(self.n_shards) if shard is None else (shard,)
        return sum(self.transformed[p.leaf]
                   for s in shards for p in self.pieces[s])


def _normalize(index: Index, shape: Tuple[int, ...]) -> Tuple:
    out = []
    for s, dim in zip(index, shape):
        out.append((0 if s.start is None else int(s.start),
                    dim if s.stop is None else int(s.stop)))
    return tuple(out)


def plan_tag(mesh: Mesh, rules: ShardingRules) -> str:
    """Deterministic identity of a (mesh shape, rules) combination — part
    of the shard cache key: the same unit planned under different rules
    (or mesh shape) holds different byte ranges, and a shared WeightCache
    must never serve one as the other."""
    desc = repr(sorted(rules.mapping.items())).encode()
    return "%s#%08x" % ("x".join(str(s) for s in mesh.devices.shape),
                        zlib.crc32(desc) & 0xFFFFFFFF)


def plan_unit(store, model_name: str, unit: str, abstract_unit,
              mesh: Mesh, rules: ShardingRules,
              apply_dtype: Optional[torch.dtype] = None) -> UnitShardPlan:
    """One retrieval stream per mesh device; each distinct leaf slice is
    owned by the first device that holds it (replicas commit without
    re-reading), whole-payload leaves round-robin across streams.

    apply_dtype: the engine's weight-application cast target.  Leaves the
    apply path transforms — int8, or floating under a cast — record their
    ``out_dtype`` so the placement lane runs ``weight_transform`` on each
    piece before committing; their allocation holds the transformed
    dtype."""
    devices = list(mesh.devices.flat)
    pos = {d: i for i, d in enumerate(devices)}
    n = len(devices)
    specs = leaf_specs(abstract_unit, mesh, rules)
    recs = store.manifest(model_name)["units"][unit]["extents"]
    pieces: List[List[LeafPiece]] = [[] for _ in range(n)]
    shapes: Dict[str, Tuple[int, ...]] = {}
    dtypes: Dict[str, str] = {}
    quant: Dict[str, bool] = {}
    commit: Dict[str, bool] = {}
    transformed: Dict[str, bool] = {}
    out_dtype: Dict[str, Optional[torch.dtype]] = {}
    rr = 0
    for rec in recs:
        leaf = rec["path"]
        shape = tuple(rec["shape"])
        shapes[leaf] = shape
        dtypes[leaf] = rec["dtype"]
        quant[leaf] = rec.get("quant") == "int8"
        if quant[leaf]:
            out_dtype[leaf] = apply_dtype or torch.float32
        elif apply_dtype is not None and \
                np.issubdtype(np.dtype(rec["dtype"]), np.floating):
            out_dtype[leaf] = apply_dtype
        else:
            out_dtype[leaf] = None
        transformed[leaf] = out_dtype[leaf] is not None
        sharding = specs[leaf]
        replicated = all(ax is None for ax in sharding.spec)
        per_device = rec["nbytes"] if replicated else rec["nbytes"] // n
        commit[leaf] = per_device >= COMMIT_FLOOR_BYTES
        whole = replicated
        groups: Dict[Tuple, Tuple[Index, List[Any]]] = {}
        if not whole:
            imap = sharding.devices_indices_map(shape)
            itemsize = 1 if quant[leaf] else np.dtype(rec["dtype"]).itemsize
            for d in devices:
                idx = imap[d]
                groups.setdefault(_normalize(idx, shape), (idx, []))[1] \
                    .append(d)
            for idx, _ds in groups.values():
                runs = slice_byte_runs(shape, itemsize, idx)
                if runs and min(nb for _, nb in runs) < RUN_FLOOR_BYTES:
                    whole = True        # strided fine-grained slices:
                    break               # read once, commit sharded
        if whole:
            pieces[rr % n].append(
                LeafPiece(leaf, None, rec["nbytes"], tuple(devices)))
            rr += 1
            continue
        for idx, ds in groups.values():
            owner = min(pos[d] for d in ds)
            nb = store.leaf_slice_nbytes(model_name, unit, leaf, idx)
            pieces[owner].append(LeafPiece(leaf, idx, nb, tuple(ds)))
    return UnitShardPlan(unit, mesh, specs, pieces, shapes, dtypes, quant,
                         commit, transformed, out_dtype,
                         plan_tag(mesh, rules))


class ShardedUnitData:
    """Per-load accumulation of one unit's arriving shards.

    ``add_shard`` (called on placement lanes, one call per shard, on the
    lane's CUDA stream) runs the per-shard ``weight_transform`` on
    transformed pieces and commits each piece into its slice of the
    leaf's one allocation on the physical device; the leaves that commit
    late are merged on the host and placed when the last shard lands.
    Then :meth:`wait` orders a reader's stream after every shard's work
    and :attr:`compute_bufs` are the unit's leaves.
    """

    def __init__(self, plan: UnitShardPlan, *, trace=None):
        """Allocates, on the calling thread's stream, the one buffer of
        every leaf that lanes commit slice by slice, and records an event
        that each lane waits on before it writes: the allocator may hand
        out a block whose last use is still pending on the allocating
        stream, and no lane may write the block before that use ends.

        trace: a PipelineTrace — each shard whose lane ran
        ``weight_transform`` gets a ``T`` event (``meta={"shard": i}``).
        On the card its span is timed by CUDA events on the lane's stream
        (the lane never waits for its kernels) and reaches the trace
        through :meth:`trace_transforms` once the load has synchronized."""
        self.plan = plan
        self.trace = trace
        self.device: torch.device = plan.mesh.device
        self._cuda = self.device.type == "cuda"
        self._lock = analysis.make_lock("ShardedUnitData._lock")
        # the leaves placed when the last shard lands: full host tensors
        self._host: Dict[str, torch.Tensor] = {}              # guarded-by: _lock
        # per shard on the card: (shard, host start, start and end events)
        self._spans: List[Tuple[int, float, Any, Any]] = []   # guarded-by: _lock
        self._events: List[Any] = []                          # guarded-by: _lock
        self._arrived = 0                                     # guarded-by: _lock
        self._ready: Any = None                               # guarded-by: _lock
        ranged = sorted({p.leaf for pieces in plan.pieces for p in pieces
                         if p.index is not None and self._eager(p.leaf)})
        # leaf -> its one allocation on the physical device (transformed
        # dtype for transformed leaves): the steady-state leaf
        self._dev: Dict[str, torch.Tensor] = {                # guarded-by: _lock
            leaf: torch.empty(plan.shapes[leaf], device=self.device,
                              dtype=plan.out_dtype[leaf] or
                              _DTYPES[plan.dtypes[leaf]])
            for leaf in ranged}
        self._allocated = None
        if self._cuda and ranged:
            self._allocated = torch.cuda.Event()
            self._allocated.record(torch.cuda.current_stream(self.device))

    def _eager(self, leaf: str) -> bool:
        """Whether lanes commit the leaf piece by piece (else it is
        placed from the host when the last shard lands)."""
        return self.plan.transformed[leaf] or self.plan.commit[leaf]

    # ------------------------------------------------------------- host side
    def _host_full(self, leaf: str) -> torch.Tensor:
        """A late leaf's full host tensor (pinned on a GPU host), made by
        the first shard that needs it — outside the lock: a pinned
        allocation can take milliseconds, and a racing twin is dropped."""
        with self._lock:
            full = self._host.get(leaf)
        if full is not None:
            return full
        plan = self.plan
        full = torch.empty(plan.shapes[leaf], dtype=_DTYPES[plan.dtypes[leaf]],
                           pin_memory=self._cuda)
        with self._lock:
            return self._host.setdefault(leaf, full)

    def host_dest(self, leaf: str, index: Index) -> Optional[torch.Tensor]:
        """Where a cache-less read of ``leaf[index]`` gathers.  A late
        leaf: a writable view of its full host tensor (no staging copy).
        A leaf that lanes commit piece by piece: None — the read gathers
        into a contiguous (pinned) tensor of its own, which the lane
        copies to the card as it is: one gather either way."""
        if self._eager(leaf):
            return None
        return self._host_full(leaf)[tuple(index)]

    # ----------------------------------------------------------- device side
    def _transform(self, arr: torch.Tensor, scale: Optional[torch.Tensor],
                   leaf: str) -> torch.Tensor:
        """The apply stage for one piece on the calling lane's stream:
        host-to-device copy, then ``weight_transform`` on a contiguous
        ``(-1, cols)`` view (columns = the piece's last dim)."""
        d = arr.to(self.device, non_blocking=True)
        w2 = d.reshape(-1, d.shape[-1]) if d.dim() >= 2 else d[None]
        s = None if scale is None else scale.to(self.device,
                                                non_blocking=True)
        t = ops.weight_transform(w2.contiguous(), s,
                                 out_dtype=self.plan.out_dtype[leaf])
        return t.reshape(arr.shape)

    def _commit(self, leaf: str, index: Optional[Index], src: torch.Tensor):
        """Commit one piece (host or device) on the calling lane's stream:
        a whole payload becomes the leaf's allocation, a slice is copied
        into its slice of the allocation made at construction."""
        if index is None:
            buf = src.to(self.device, non_blocking=True).reshape(
                self.plan.shapes[leaf])
            with self._lock:
                self._dev[leaf] = buf
        else:
            with self._lock:
                buf = self._dev[leaf]
            buf[tuple(index)].copy_(src, non_blocking=True)
        if self._cuda:           # written on this lane's stream
            buf.record_stream(torch.cuda.current_stream(self.device))

    def add_shard(self, shard: int, payload: ShardPayload,
                  merged: bool = False) -> bool:
        """``merged=True``: the late leaves' ranged pieces were gathered
        straight into their full host tensors via :meth:`host_dest`.
        Returns True for exactly one caller: the one whose shard
        completed the unit (after the unit's ready event is recorded —
        the publish signal)."""
        plan = self.plan
        stream = None
        if self._cuda:
            stream = torch.cuda.current_stream(self.device)
            if self._allocated is not None:
                stream.wait_event(self._allocated)
        t_t0, start = None, None    # this shard's transform-work span
        for leaf, arr, scale, index in payload:
            if plan.transformed[leaf]:               # per-shard apply
                if t_t0 is None:
                    t_t0 = time.monotonic()
                    if stream is not None:
                        start = torch.cuda.Event(enable_timing=True)
                        start.record(stream)
                self._commit(leaf, index, self._transform(arr, scale, leaf))
            elif plan.commit[leaf]:                  # eager mesh commit
                self._commit(leaf, index, arr)
            elif index is None:                      # late, whole payload
                with self._lock:
                    self._host[leaf] = arr
            elif not merged:                         # late, disjoint slice
                self._host_full(leaf)[tuple(index)] = arr
        ev = None
        if stream is not None:
            ev = torch.cuda.Event(enable_timing=start is not None)
            ev.record(stream)
        if t_t0 is not None and self.trace is not None:
            if start is None:        # the CPU: the work is done
                self.trace.add_event("T", plan.unit, t_t0, time.monotonic(),
                                     meta={"shard": shard})
            else:
                with self._lock:
                    self._spans.append((shard, t_t0, start, ev))
        with self._lock:
            self._events.append(ev)
            self._arrived += 1
            last = self._arrived >= plan.n_shards
        if last:
            self._finish()
        return last

    def _finish(self):
        """The unit's last shard landed: order this lane after every
        shard's work, place the late leaves from their host tensors, and
        record the ready event."""
        stream = torch.cuda.current_stream(self.device) if self._cuda \
            else None
        with self._lock:
            events = list(self._events)
            late = list(self._host.items())
        for ev in events:
            if ev is not None:
                stream.wait_event(ev)
        for leaf, host in late:
            self._commit(leaf, None, host)
        ready: Any = True
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(stream)
        with self._lock:
            self._ready = ready

    # ---------------------------------------------------------------- readers
    def wait(self):
        """Order the calling thread's stream after every shard's copies
        and kernels (a no-op on the CPU)."""
        with self._lock:
            ready = self._ready
        if ready is None:
            raise RuntimeError(f"{self.plan.unit}: not every shard landed")
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(ready)

    @property
    def compute_bufs(self) -> Dict[str, torch.Tensor]:
        """Every leaf's allocation on the physical device, transformed
        where the plan transforms it — the unit's leaves for E and for
        the steady-state params (every logical device of the mesh lies on
        that device), so A neither copies nor transforms again."""
        with self._lock:
            return dict(self._dev) if self._ready is not None else {}

    def trace_transforms(self):
        """Add the ``T`` events timed on the card (the CPU adds them in
        :meth:`add_shard`): each starts at the host time its lane began
        the shard's transforms and lasts the device time from the first
        transform to the shard's last commit.  Call once the device has
        synchronized."""
        with self._lock:
            spans, self._spans = self._spans, []
        for shard, t0, start, end in spans:
            self.trace.add_event("T", self.plan.unit, t0,
                                 t0 + start.elapsed_time(end) / 1e3,
                                 meta={"shard": shard})
