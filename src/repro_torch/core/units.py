"""Event-driven pipeline execution units (paper Fig. 2 decomposition).

  * :class:`PipelineState` — a shared blackboard: per-(stage, unit)
    completion slots guarded by **one** condition variable.  Producers
    :meth:`publish`, consumers :meth:`wait_for` / :meth:`wait_until`;
    every wait is woken by notification (or an explicit Algorithm-1
    deadline), never by a polling interval.
  * :class:`PipelineUnit` — base class for an execution unit; concrete
    units are :class:`LayerConstructionUnit`,
    :class:`DecoupledWeightUnit` (async retrieval, out-of-order
    application), :class:`FusedWeightUnit` (PISeL: retrieval fused,
    strictly ordered) and :class:`ComputeUnit`.
  * :class:`PipelineRuntime` — runs a unit set as threads and
    propagates the first failure.

On the GPU the weight unit applies on its own CUDA stream (the
host-to-device copy and ``weight_transform``), records an event there and
waits for that event — only its own work — before it publishes a unit and
releases the unit's WeightCache pin, so no copy out of a cached pinned
buffer is still in flight when the cache may evict it.
The compute unit runs on a second stream, makes that stream wait on the
unit's event, and closes each E event after waiting for its own stream.
No unit calls ``torch.cuda.synchronize()``, which would also wait for the
other thread's copies and erase the L/R/A/E overlap the trace measures.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import analysis
from repro_torch import tree as tree_util
from repro_torch.core import miniloader
from repro_torch.core.pipeline import PipelineTrace
from repro_torch.core.scheduler import PriorityAwareScheduler
from repro_torch.core.strategies import Strategy
from repro_torch.device import synchronize

PyTree = Any

# Canonical stage names on the blackboard.  L produces CONSTRUCTED, A
# produces APPLIED (and, on the GPU, the unit's READY event), E produces
# OUTPUT.
CONSTRUCTED = "constructed"
APPLIED = "applied"
READY = "ready"
OUTPUT = "output"


class PipelineState:
    """Shared completion slots for one pipeline run, one condition
    variable for all signaling.

    The condition variable is exposed (``state.cv``) so collaborating
    components that complete work on other threads — the
    WeightDecoupler's I/O pool — can share it: their completions then
    wake any unit blocked here without a second lock or a poll loop.
    """

    def __init__(self, cv: Optional[threading.Condition] = None):
        self.cv = cv if cv is not None \
            else analysis.make_condition("PipelineState.cv")
        self._slots: Dict[str, Dict[str, Any]] = {}   # guarded-by: cv
        self.errors: List[BaseException] = []         # guarded-by: cv

    # ------------------------------------------------------------ producers
    def publish(self, stage: str, unit: str, value: Any = True):
        with self.cv:
            self._slots.setdefault(stage, {})[unit] = value
            self.cv.notify_all()

    def fail(self, exc: BaseException):
        with self.cv:
            if not any(e is exc for e in self.errors):
                self.errors.append(exc)
            self.cv.notify_all()

    # ------------------------------------------------------------ consumers
    def peek(self, stage: str) -> Dict[str, Any]:
        with self.cv:
            return dict(self._slots.get(stage, {}))

    def get(self, stage: str, unit: str) -> Any:
        with self.cv:
            return self._slots.get(stage, {}).get(unit)

    def wait_until(self, predicate: Callable[[], Any], *,
                   deadline_fn: Optional[Callable[[], Optional[float]]] = None,
                   on_deadline: Optional[Callable[[], None]] = None) -> Any:
        """Block until ``predicate()`` (evaluated under the lock) returns
        non-None; re-raises the first pipeline error.

        ``deadline_fn`` may supply a wake-up delay in seconds (None = no
        deadline).  When the deadline expires before a notification,
        ``on_deadline`` runs once and the deadline is re-asked — this is
        how Algorithm 1 fires exactly at a late stream's expected
        completion instead of on a polling grid.
        """
        with self.cv:
            while True:
                if self.errors:
                    raise self.errors[0]
                value = predicate()
                if value is not None:
                    return value
                wait_s = deadline_fn() if deadline_fn is not None else None
                if wait_s is not None and wait_s <= 0:
                    if on_deadline is not None:
                        on_deadline()
                    continue
                self.cv.wait(wait_s)

    def wait_for(self, stage: str, unit: str) -> Any:
        return self.wait_until(
            lambda: self._slots.get(stage, {}).get(unit))


@dataclasses.dataclass
class PipelineContext:
    """Everything a unit needs for one cold-start run."""
    model: Any
    units: List[str]                     # layer order
    seeds: List[int]                     # per-unit construction seeds
    batch: Dict[str, torch.Tensor]
    strategy: Strategy
    trace: PipelineTrace
    decoupler: Any                       # WeightDecoupler
    scheduler: PriorityAwareScheduler
    state: PipelineState
    # (unit, abstract, retrieved leaves) -> applied unit tree on device
    apply_leaves: Callable[[str, PyTree, Any], PyTree]
    apply_fn: Callable[[str], Callable]
    device: torch.device
    # Called with the request's logits as soon as the final unit's E
    # completes them — while that E event is still open, before the
    # pipeline drains/assembles: a cold generation request's first token
    # is produced inside the pipeline.
    on_output: Optional[Callable[[Any], None]] = None
    # CUDA streams of the weight and compute units (None on the CPU)
    weight_stream: Any = None
    compute_stream: Any = None

    def index(self, unit: str) -> int:
        return self.units.index(unit)


def _on_stream(stream):
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def _record_ready(device: torch.device):
    """Event after the calling thread's queued work, waited for on the
    host (the reference's ``block_until_ready`` of an applied unit);
    None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    ev.synchronize()
    return ev


def _use_applied(ev, params: PyTree, device: torch.device):
    """Order the calling thread's stream after the unit's READY event and
    tell the allocator the unit's tensors are used on this stream."""
    if ev is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ev)
    for t in tree_util.leaves(params):
        t.record_stream(stream)


class PipelineUnit:
    """One execution unit; runs on its own thread via PipelineRuntime."""

    name = "pipeline-unit"

    def __init__(self, ctx: PipelineContext):
        self.ctx = ctx

    def run(self):                       # pragma: no cover - interface
        raise NotImplementedError

    def thread(self) -> threading.Thread:
        def _runner():
            try:
                self.run()
            except BaseException as e:
                self.ctx.state.fail(e)
        return threading.Thread(target=_runner, name=self.name)


class LayerConstructionUnit(PipelineUnit):
    """L_i: build unit structures in order (MiniLoader or full init)."""

    name = "layer-unit"

    def run(self):
        ctx = self.ctx
        for u, seed in zip(ctx.units, ctx.seeds):
            if ctx.strategy.scheduler:
                # Algorithm 1 at L_i — for the layer the pipeline needs
                # NEXT (lowest un-applied), not the one being built
                applied = ctx.state.peek(APPLIED)
                needed = next((x for x in ctx.units if x not in applied),
                              u)
                ctx.scheduler.adjust_priority(needed)
            with ctx.trace.record("L", u):
                cu = miniloader.construct_unit(ctx.model, u, seed,
                                               mini=ctx.strategy.mini,
                                               device=ctx.device)
            ctx.state.publish(CONSTRUCTED, u, cu)


class DecoupledWeightUnit(PipelineUnit):
    """A_i out of order: apply any unit whose structure is built and
    whose retrieval stream (issued at request arrival) has landed."""

    name = "weight-unit"

    def run(self):
        ctx = self.ctx
        dec = ctx.decoupler
        if dec.cv is not ctx.state.cv:
            # bytes-ready signals must arrive on the state's CV, or waits
            # below would sleep through them (silent hang)
            raise RuntimeError("WeightDecoupler must share the "
                               "PipelineState CV (state=...)")
        pending = set(ctx.units)
        with torch.no_grad(), _on_stream(ctx.weight_stream):
            while pending:
                u = self._next_ready(pending)
                cu = ctx.state.get(CONSTRUCTED, u)
                with ctx.trace.record("A", u):
                    params = ctx.apply_leaves(u, cu.abstract, dec.ready[u])
                    ev = _record_ready(ctx.device)
                # application done — on the GPU, the host has waited for
                # the copies out of the pinned leaves: drop the cache pin
                dec.checkin(u)
                ctx.trace.record_memory(u, cu.mem_bytes, cu.t_construct_end,
                                        time.monotonic())
                ctx.state.publish(READY, u, ev)
                ctx.state.publish(APPLIED, u, params)
                pending.discard(u)

    def _next_ready(self, pending) -> str:
        """Lowest-index pending unit with structure + bytes ready.

        While blocked, wake exactly at the *critical* unit's expected
        completion (the one the compute unit needs next) and run
        Algorithm 1 so a late stream gets the full I/O bandwidth.
        """
        ctx = self.ctx
        dec = ctx.decoupler
        critical = min(pending, key=ctx.index)

        def _avail() -> Optional[str]:
            built = ctx.state._slots.get(CONSTRUCTED, {})
            got = [u for u in pending if u in built and u in dec.ready]
            return min(got, key=ctx.index) if got else None

        deadline = (ctx.scheduler.time_until_expected
                    if ctx.strategy.scheduler else None)
        return ctx.state.wait_until(
            _avail,
            deadline_fn=(lambda: deadline(critical)) if deadline else None,
            on_deadline=lambda: ctx.scheduler.adjust_priority(critical))


class FusedWeightUnit(PipelineUnit):
    """PISeL W_i: retrieval fused into the unit, strictly ordered after
    L_i — the unit idles on I/O (that idleness is the paper's point)."""

    name = "weight-unit"

    def run(self):
        ctx = self.ctx
        with torch.no_grad(), _on_stream(ctx.weight_stream):
            for u in ctx.units:
                cu = ctx.state.wait_for(CONSTRUCTED, u)
                t0 = time.monotonic()
                leaves = ctx.decoupler.fetch_sync(u)
                t_io = time.monotonic()
                params = ctx.apply_leaves(u, cu.abstract, leaves)
                ev = _record_ready(ctx.device)
                t1 = time.monotonic()
                ctx.trace.add_event("R", u, t0, t_io)
                ctx.trace.add_event("A", u, t_io, t1)
                ctx.trace.record_memory(u, cu.mem_bytes, cu.t_construct_end,
                                        t1)
                ctx.state.publish(READY, u, ev)
                ctx.state.publish(APPLIED, u, params)


class ComputeUnit(PipelineUnit):
    """E_i: run layer i as soon as its weights are applied — the
    triggering request is answered while the model is still loading."""

    name = "compute-unit"

    def run(self):
        ctx = self.ctx
        st: Dict[str, Any] = {"batch": ctx.batch}
        last = ctx.units[-1]
        with torch.no_grad(), _on_stream(ctx.compute_stream):
            for u in ctx.units:
                params = ctx.state.wait_for(APPLIED, u)
                with ctx.trace.record("E", u):
                    _use_applied(ctx.state.get(READY, u), params, ctx.device)
                    st = ctx.apply_fn(u)(params, st)
                    synchronize(ctx.device)      # this stream's work only
                    if u == last and ctx.on_output is not None:
                        # first token sampled inside the final E event
                        ctx.on_output(st["logits"])
        ctx.state.publish(OUTPUT, "logits", st["logits"])


class PipelineRuntime:
    """Run a set of units to completion; surface the first error."""

    def __init__(self, units: Sequence[PipelineUnit], state: PipelineState):
        self.units = list(units)
        self.state = state

    def run(self):
        threads = [u.thread() for u in self.units]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.state.errors:
            raise self.state.errors[0]


def standard_units(ctx: PipelineContext) -> List[PipelineUnit]:
    """The paper's three-unit pipeline for a strategy: the same runtime
    drives both the fused (PISeL) and decoupled weight paths."""
    weight_cls = (DecoupledWeightUnit if ctx.strategy.decouple
                  else FusedWeightUnit)
    return [LayerConstructionUnit(ctx), weight_cls(ctx), ComputeUnit(ctx)]
