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

Single device: the reference's mesh (shard-granular) cold starts and its
cluster ``source=`` come with later slices (ROADMAP queue 1 items 13 and
14); passing them raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import metrics as metrics_mod
from repro_torch import tree as tree_util
from repro_torch.core import miniloader
from repro_torch.core.decoupler import WeightDecoupler
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.strategies import Strategy, get_strategy
from repro_torch.core.units import (APPLIED, OUTPUT, PipelineContext,
                                    PipelineRuntime, PipelineState,
                                    standard_units)
from repro_torch.device import DeviceLike, resolve_device, synchronize
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


class ColdStartEngine:
    def __init__(self, model, model_name: str, store: WeightStore, *,
                 strategy: str = "cicada", io_workers: int = 4,
                 chunk_bytes: int = 1 << 20,
                 apply_dtype: Optional[torch.dtype] = None,
                 compute_quant: bool = False,
                 cache: Optional[WeightCache] = None,
                 mesh=None, rules=None,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 source=None, device: DeviceLike = None):
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

        mesh / rules / source: shard-granular cold starts and the
        cluster's peer source of the reference; not ported yet (ROADMAP
        queue 1 items 13 and 14), so anything but None raises.

        device: where the model is loaded and run (default: the GPU;
        raises without one unless ``device="cpu"``)."""
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "shard-granular cold starts (mesh=, rules=) are not ported "
                "yet — ROADMAP queue 1 item 13")
        if source is not None:
            raise NotImplementedError(
                "a cluster ShardSource (source=) is not ported yet — "
                "ROADMAP queue 1 item 14")
        self.model = model
        self.model_name = model_name
        self.store = store
        self.strategy: Strategy = get_strategy(strategy)
        self.io_workers = io_workers
        self.chunk_bytes = chunk_bytes
        self.apply_dtype = apply_dtype
        self.compute_quant = compute_quant
        self.cache = cache
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
        dec = WeightDecoupler(self.store, self.model_name, scheduler, trace,
                              state, io_workers=self.io_workers,
                              chunk_bytes=self.chunk_bytes,
                              cache=self.cache if strat.decouple else None)
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
        params = self.model.assemble(applied)
        synchronize(self.device)
        return LoadResult(state["logits"], params, trace,
                          self.strategy.name)

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
            apply_leaves=self._apply_leaves, apply_fn=self._apply_fn,
            device=self.device, on_output=on_logits,
            weight_stream=torch.cuda.Stream(self.device) if cuda else None,
            compute_stream=torch.cuda.Stream(self.device) if cuda else None)
        PipelineRuntime(standard_units(ctx), state).run()
        with torch.no_grad():
            params = self.model.assemble(state.peek(APPLIED))
        synchronize(self.device)
        return LoadResult(state.get(OUTPUT, "logits"), params, trace,
                          strat.name)


def _named(abstract: PyTree):
    for path, leaf in tree_util.leaves_with_path(abstract):
        yield "/".join(path), leaf
