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

Single device: the reference's mesh (shard-granular) cold starts, its
``WeightCache``, ``compute_quant`` and metrics registry come with later
slices (ROADMAP queue 1 items 6, 8, 9 and 13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

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
from repro_torch.models.transformer import unit_seed
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
                 device: DeviceLike = None):
        """apply_dtype: cast weights to this dtype at application time
        (None -> keep the stored dtype; int8 extents dequantize to f32).

        device: where the model is loaded and run (default: the GPU;
        raises without one unless ``device="cpu"``)."""
        self.model = model
        self.model_name = model_name
        self.store = store
        self.strategy: Strategy = get_strategy(strategy)
        self.io_workers = io_workers
        self.chunk_bytes = chunk_bytes
        self.apply_dtype = apply_dtype
        self.device = resolve_device(device)
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
        ``weight_transform`` kernel for int8 and ``apply_dtype`` leaves."""
        dev = self.device
        shapes = {n: ab.shape for n, ab in _named(abstract)}
        flat = {}
        for name, (arr, scale) in leaves.items():
            d = arr.to(dev, non_blocking=True)
            if scale is not None:                       # int8 extent
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
                              chunk_bytes=self.chunk_bytes)
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
            dec.shutdown()
        trace.finish()
        return result

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
