"""ColdStartEngine: request -> live model, through the paper's pipeline.

Three execution units run as threads (the paper's decomposition, as
:class:`~repro_torch.core.units.PipelineUnit` objects on one event-driven
:class:`~repro_torch.core.units.PipelineRuntime`):

  * **Layer unit** — constructs unit structures in order (MiniLoader on
    the meta device, or PISeL-faithful numerical init on the device);
  * **Weight unit** — applies retrieved weights: a non-blocking copy of
    the pinned host leaves to the device on the unit's own CUDA stream,
    then ``weight_transform`` (int8 dequant, or the ``apply_dtype``
    cast).  Under the WeightDecoupler retrieval streams were issued at
    request arrival and application is out of order; under PISeL
    retrieval is fused into this unit and strictly ordered after L_i;
  * **Compute unit** — executes layer i on its own stream as soon as its
    weights are applied (and layer i-1 executed): the triggering request
    is answered *while the model is still loading*.

Under ``compute_quant`` A keeps int8 extents resident as
:class:`~repro_torch.quant.QuantLeaf` (no ``weight_transform``), and the
forward runs their contractions through ``quant_matmul``.

With a node-local :class:`~repro_torch.store.cache.WeightCache`
(``cache=``) decoupled retrieval streams consult it before any store
read, so scale-out and re-triggered cold starts of one model reuse its
retrieved leaves and single-flight every read.  Each load records its
instruments (``coldstart/loads``, ``coldstart/load_s``,
``coldstart/utilization``, ``pipeline/wait_A_s``, ``pipeline/wait_E_s``)
in the ``metrics=`` registry.

With ``source=`` (a :class:`~repro_torch.core.decoupler.ShardSource`,
e.g. a cluster node's peer-exchange tier) the decoupled streams that
miss the cache read their bytes through it instead of the origin store.

**Shard-granular cold starts** (``mesh=`` + ``rules=``): the unit of
pipelined retrieval becomes a *(layer-unit, shard)* pair — one stream per
mesh device, each reading only the byte ranges its device owns, its
pieces transformed and committed on a placement lane the moment they land
(see :mod:`repro_torch.core.shards`).  The port's mesh is logical: every
device of it lies on the engine's one physical device, so the one
allocation a leaf's shards commit into is the leaf that E and the
steady-state params use, and the load's logits and params are bit-equal
to the single-device load's.  ``LoadResult.shardings`` says how each
steady-state leaf is laid out over the mesh.  The fused strategies
(``pisel``, ``mini``, ``traditional``) keep unit-granular reads.  A mesh
of one device is exactly the seed path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import metrics as metrics_mod
from repro_torch import tree as tree_util
from repro_torch.core import miniloader
from repro_torch.core.decoupler import ShardSource, WeightDecoupler
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.shards import ShardedUnitData, UnitShardPlan, plan_unit
from repro_torch.core.strategies import Strategy, get_strategy
from repro_torch.core.units import (APPLIED, OUTPUT, PipelineContext,
                                    PipelineRuntime, PipelineState,
                                    standard_units)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.distributed.sharding import (ShardingRules, param_specs,
                                              serve_rules)
from repro_torch.kernels import ops
from repro_torch.models.api import Family
from repro_torch.models.transformer import unit_seed
from repro_torch.quant import QuantLeaf
from repro_torch.store.cache import WeightCache
from repro_torch.store.store import Leaves, WeightStore, unflatten_unit

PyTree = Any


@dataclasses.dataclass
class LoadResult:
    logits: torch.Tensor         # first-request output (computed in-pipeline)
    params: PyTree               # assembled steady-state parameters
    trace: PipelineTrace
    strategy: str
    # each steady-state leaf's NamedSharding over the engine's mesh
    # (None without one)
    shardings: Optional[PyTree] = None


class ColdStartEngine:
    def __init__(self, model, model_name: str, store: WeightStore, *,
                 strategy: str = "cicada", io_workers: int = 4,
                 chunk_bytes: int = 1 << 20,
                 apply_dtype: Optional[torch.dtype] = None,
                 compute_quant: bool = False,
                 cache: Optional[WeightCache] = None,
                 mesh=None, rules=None,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 source: Optional[ShardSource] = None,
                 device: DeviceLike = None):
        """apply_dtype: cast weights to this dtype at application time
        (None -> keep the stored dtype; int8 extents dequantize to f32).
        The vision family takes None only.

        compute_quant: keep int8 extents resident — A copies the int8
        values (at the leaf's logical shape) and the scale to the device
        as a :class:`~repro_torch.quant.QuantLeaf` and launches no
        ``weight_transform`` for them, so params hold about a quarter of
        the f32 bytes and the forward dispatches ``quant_matmul``.
        Leaves the store serves as floats are handled as without it.

        cache: node-local shared WeightCache — decoupled retrieval
        streams consult it before issuing I/O, so scale-out cold starts
        of the same model single-flight every store read (strategies
        without the decoupler read the store as before).

        metrics: registry of the per-load instruments (default: the
        process registry).

        source: where cache-missing streams read their bytes (default:
        the origin store) — a cluster node passes its peer-exchange
        tier.  Used only by strategies that decouple, and only with a
        cache.

        mesh / rules: shard-granular cold start — retrieval fans out
        into one stream per mesh device (a ``Mesh`` of logical devices on
        ``device``, :func:`repro_torch.launch.mesh.make_serving_mesh`);
        rules defaults to ``serve_rules()``; a 1-device mesh is the seed
        path.

        device: where the model is loaded and run (default: the GPU;
        raises without one unless ``device="cpu"``)."""
        if rules is not None and not isinstance(rules, ShardingRules):
            raise TypeError(f"rules must be a ShardingRules, got "
                            f"{type(rules).__name__}")
        if mesh is not None and mesh.size <= 1:
            mesh = None                    # degenerate: exact seed path
        if compute_quant and mesh is not None:
            raise ValueError(
                "compute_quant serves int8 leaves in place on a single "
                "device; mesh-sharded quantized residency is not "
                "supported (shard plans describe the dequantized layout)")
        self.mesh = mesh
        self.rules = (rules if rules is not None else serve_rules()) \
            if mesh is not None else None
        self._shard_plans: Dict[str, UnitShardPlan] = {}
        self._param_specs: Optional[PyTree] = None
        self.model = model
        self.model_name = model_name
        self.store = store
        self.strategy: Strategy = get_strategy(strategy)
        self.io_workers = io_workers
        self.chunk_bytes = chunk_bytes
        self.apply_dtype = apply_dtype
        self.compute_quant = compute_quant
        self.cache = cache
        self.source = source
        self.metrics = metrics_mod.resolve(metrics)
        self.device = resolve_device(device)
        if compute_quant and model.cfg.family == Family.VISION:
            raise NotImplementedError(
                f"{model.cfg.name}: compute_quant is not supported for the "
                f"vision family: its params stay f32, as in the reference")
        if apply_dtype is not None and model.cfg.family == Family.VISION:
            raise NotImplementedError(
                f"{model.cfg.name}: apply_dtype is not supported for the "
                f"vision family: its params stay f32, as in the reference, "
                f"whose convs take no bf16 weights under f32 activations")
        if model.device != self.device:
            raise ValueError(f"model is built for {model.device}, engine "
                             f"runs on {self.device}")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh lies on {mesh.device}, engine runs on "
                             f"{self.device}")

    # -------------------------------------------------------------- helpers
    def _apply_fn(self, unit: str) -> Callable:
        model = self.model
        return lambda p, s: model.unit_apply(unit, p, s)

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in
                batch.items()}

    def warmup(self, batch: Dict[str, Any]):
        """Deploy-time step: build the kernel library (on the GPU) and run
        every unit once on freshly initialized weights, so first-request
        timings measure execution, not ``nvcc`` or lazy CUDA set-up."""
        if self.device.type == "cuda":
            ops.registry.build()
        state: Dict[str, Any] = {"batch": self._batch(batch)}
        for i, name in enumerate(self.model.unit_names()):
            self.model.abstract_unit(name)   # precompute static structure
            gen = torch.Generator(device=self.device)
            gen.manual_seed(i)
            p = self.model.init_unit(name, gen)
            state = self._apply_fn(name)(p, state)
        synchronize(self.device)

    def _plan(self, unit: str) -> UnitShardPlan:
        """Static per-unit shard plan (kept across loads)."""
        if unit not in self._shard_plans:
            self._shard_plans[unit] = plan_unit(
                self.store, self.model_name, unit,
                self.model.abstract_unit(unit), self.mesh, self.rules,
                apply_dtype=self.apply_dtype)
        return self._shard_plans[unit]

    def _apply_leaves(self, unit: str, abstract: PyTree,
                      leaves: Leaves) -> PyTree:
        """The weight-application phase on the calling thread's stream:
        host-to-device copy (non-blocking from pinned memory) and the
        ``weight_transform`` kernel for int8 and ``apply_dtype`` leaves;
        under ``compute_quant`` int8 leaves stay int8 as ``QuantLeaf``s."""
        dev = self.device
        shapes = {n: ab.shape for n, ab in _named(abstract)}
        flat = {}
        for name, (arr, scale) in leaves.items():
            d = arr.to(dev, non_blocking=True)
            if scale is not None and self.compute_quant:
                flat[name] = QuantLeaf(d.reshape(shapes[name]),
                                       scale.to(dev, non_blocking=True))
            elif scale is not None:                     # int8 extent
                out_dt = self.apply_dtype or torch.float32
                deq = ops.weight_transform(
                    d.reshape(-1, d.shape[-1]),
                    scale.to(dev, non_blocking=True), out_dtype=out_dt)
                flat[name] = deq.reshape(shapes[name])
            elif self.apply_dtype is not None and d.is_floating_point():
                w2 = d.reshape(d.shape[0], -1) if d.dim() >= 2 else d[None]
                flat[name] = ops.weight_transform(
                    w2, None, out_dtype=self.apply_dtype).reshape(d.shape)
            else:
                flat[name] = d
        return unflatten_unit(abstract, flat)

    def _apply_unit(self, unit: str, abstract: PyTree, leaves) -> PyTree:
        """A_i.  After a sharded retrieval the placement lanes have
        already copied (and, for dequant/cast leaves, transformed) every
        leaf into its one allocation on the device, where every logical
        device of the mesh lies: this stream waits for their work and
        takes those leaves as they are."""
        if isinstance(leaves, ShardedUnitData):
            leaves.wait()           # this stream after every shard's work
            return unflatten_unit(abstract, leaves.compute_bufs)
        return self._apply_leaves(unit, abstract, leaves)

    def _shardings(self, params: PyTree) -> Optional[PyTree]:
        """The steady-state leaves' NamedShardings (from their shapes,
        which every load shares)."""
        if self.mesh is not None and self._param_specs is None:
            self._param_specs = param_specs(params, self.mesh, self.rules)
        return self._param_specs

    # ----------------------------------------------------------------- load
    def load(self, batch: Dict[str, Any], *, seed: int = 0,
             on_logits: Optional[Callable[[torch.Tensor], None]] = None
             ) -> LoadResult:
        """Serve one cold-start request end-to-end.

        on_logits: called with the request's logits the moment the final
        unit's E completes (inside the pipeline, before assembly) — the
        generation path samples the first token here.
        seed: seeds the PISeL-faithful construction's initializers."""
        strat = self.strategy
        units = self.model.unit_names()
        seeds = [unit_seed(seed, i) for i in range(len(units))]
        batch = self._batch(batch)

        trace = PipelineTrace()
        scheduler = PriorityAwareScheduler(enabled=strat.scheduler)
        state = PipelineState()
        sharded = self.mesh is not None and strat.decouple
        dec = WeightDecoupler(self.store, self.model_name, scheduler, trace,
                              state, io_workers=self.io_workers,
                              chunk_bytes=self.chunk_bytes,
                              cache=self.cache if strat.decouple else None,
                              source=self.source if strat.decouple
                              and self.cache is not None else None,
                              plan_fn=self._plan if sharded else None)
        trace.start()
        try:
            if not strat.pipelined:
                result = self._load_traditional(batch, units, seeds, trace,
                                                dec, on_logits)
            else:
                result = self._load_pipelined(batch, units, seeds, trace,
                                              dec, scheduler, state,
                                              on_logits)
        finally:
            # shutdown guards the shared cache's invariants (pin sweep and
            # unregister_load), so it runs on the failure path too
            dec.shutdown()
        trace.finish()
        self._record_load(trace)
        return result

    # 0..1 in even tenths — utilization is a ratio, not a latency, so
    # the log-spaced second buckets would collapse it into two bins
    UTIL_BUCKETS = tuple(i / 10 for i in range(1, 11))

    def _record_load(self, trace: PipelineTrace):
        """Per-load instruments: pipeline time, utilization, and the
        paper's per-stage waiting times (Q3) as live histograms."""
        m = self.metrics
        m.counter("coldstart/loads").inc()
        m.histogram("coldstart/load_s").observe(trace.total_time())
        m.histogram("coldstart/utilization",
                    buckets=self.UTIL_BUCKETS).observe(trace.utilization())
        wait = trace.wait_by_stage()
        m.histogram("pipeline/wait_A_s").observe(wait.get("A", 0.0))
        m.histogram("pipeline/wait_E_s").observe(wait.get("E", 0.0))

    # ------------------------------------------------- traditional (Fig. 1)
    @torch.no_grad()
    def _load_traditional(self, batch, units, seeds, trace, dec,
                          on_logits=None) -> LoadResult:
        constructed = {}
        for u, s in zip(units, seeds):                   # all L
            with trace.record("L", u):
                constructed[u] = miniloader.construct_unit(
                    self.model, u, s, mini=False, device=self.device)
        applied = {}
        for u in units:                                  # monolithic W+A
            t0 = time.monotonic()
            leaves = dec.fetch_sync(u)                   # blocking I/O
            t_io = time.monotonic()
            applied[u] = self._apply_leaves(u, constructed[u].abstract,
                                            leaves)
            synchronize(self.device)
            t1 = time.monotonic()
            trace.add_event("R", u, t0, t_io)            # unit idles (DMA)
            trace.add_event("A", u, t_io, t1)
            trace.record_memory(u, constructed[u].mem_bytes,
                                constructed[u].t_construct_end, t1)
        state: Dict[str, Any] = {"batch": batch}
        for u in units:                                  # all E
            with trace.record("E", u):
                state = self._apply_fn(u)(applied[u], state)
                synchronize(self.device)
                if u == units[-1] and on_logits is not None:
                    on_logits(state["logits"])
        params = self.model.assemble(applied, consume=True)
        synchronize(self.device)
        return LoadResult(state["logits"], params, trace,
                          self.strategy.name, self._shardings(params))

    # ------------------------------------------------------- pipelined path
    def _load_pipelined(self, batch, units, seeds, trace, dec, scheduler,
                        state: PipelineState, on_logits=None) -> LoadResult:
        strat = self.strategy
        if strat.decouple:
            dec.prefetch(units)                 # issue I/O at request arrival
        cuda = self.device.type == "cuda"
        ctx = PipelineContext(
            model=self.model, units=list(units), seeds=list(seeds),
            batch=batch, strategy=strat, trace=trace, decoupler=dec,
            scheduler=scheduler, state=state,
            apply_leaves=self._apply_unit, apply_fn=self._apply_fn,
            device=self.device, on_output=on_logits,
            weight_stream=torch.cuda.Stream(self.device) if cuda else None,
            compute_stream=torch.cuda.Stream(self.device) if cuda else None)
        PipelineRuntime(standard_units(ctx), state).run()
        with torch.no_grad():
            params = self.model.assemble(state.peek(APPLIED),
                                         consume=True)
        synchronize(self.device)
        dec.trace_transforms()          # device-timed, so after the sync
        return LoadResult(state.get(OUTPUT, "logits"), params, trace,
                          strat.name, self._shardings(params))


def _named(abstract: PyTree):
    for path, leaf in tree_util.leaves_with_path(abstract):
        yield "/".join(path), leaf
