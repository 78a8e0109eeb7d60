"""Training step + loop: remat'd loss, AdamW, preemption-safe (the port of
``repro.training.train``).

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) function.  PyTorch runs it eagerly (the reference
jits it; CUDA graphs of the step are ROADMAP item [5]).  The gradients
come from ``torch.autograd.grad`` through the model's loss, whose
attention and norms run the hand-written backward kernels on the card.
The step is deterministic by construction where the port's own kernels
run (no float atomics in ``flash_attention_bwd`` or ``rmsnorm_bwd``) and
under ``torch.use_deterministic_algorithms`` for PyTorch's own ops (the
embedding's ``index_put_`` accumulation, the loss's gather), so the same
state and batch give the same bits, which a bit-equal resume needs.  The
loop handles periodic checkpointing (atomic, via
``distributed.checkpoint``) and save-on-signal preemption safety.
"""
from __future__ import annotations

import contextlib
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.training.optim import AdamW, AdamWState

PyTree = Any


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic implementations for the ops that have one,
    a warning (not an error) for any that has none, and no fill of
    ``torch.empty`` outputs (every kernel writes its whole output); the
    previous settings come back on exit."""
    import torch.utils.deterministic as det
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        det.fill_uninitialized_memory = fill


def value_and_grad(model, params: PyTree, batch: Dict[str, torch.Tensor], *,
                   remat: bool = True, unroll: bool = False
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]],
                              PyTree]:
    """``jax.value_and_grad(model.loss, has_aux=True)`` in PyTorch: ((loss,
    metrics), grads), the grads a tree like ``params`` in their dtypes,
    everything detached."""
    named = [("/".join(p), leaf) for p, leaf in
             tree_util.leaves_with_path(params)]
    req = {n: leaf.detach().requires_grad_(leaf.is_floating_point())
           for n, leaf in named}
    with torch.enable_grad(), deterministic():
        loss, metrics = model.loss(tree_util.unflatten(params, req), batch,
                                   remat=remat, unroll=unroll)
        wrt = [n for n, _ in named if req[n].requires_grad]
        got = torch.autograd.grad(loss, [req[n] for n in wrt])
    grads = dict(zip(wrt, got))
    for n, leaf in named:
        grads.setdefault(n, torch.zeros_like(leaf))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_util.unflatten(params, grads))


def make_train_step(model, opt: AdamW, *,
                    grad_transform: Optional[Callable] = None,
                    remat: bool = True, micro_batches: int = 1,
                    unroll: bool = False, mixed_precision: bool = False,
                    donate: bool = False):
    """grad_transform(grads) -> grads: hook for DP compression etc.

    micro_batches > 1: gradient accumulation — the global batch is split
    along its leading axis into M microbatches run in order; their f32
    gradients are summed in that order and divided by M, the loss
    likewise, and the metrics are the last microbatch's.

    mixed_precision: differentiate wrt a bf16 *copy* of the params (f32
    masters stay in the optimizer), as the reference does.

    donate: the step updates the params and optimizer state it is given
    in place (``AdamW.update(donate=True)``: the same bits), as a jitted
    step that donates its buffers would; the caller gives up the old
    ones.  It halves the optimizer's peak memory, which full-width
    training of a few billion parameters on one card needs.
    """

    def grad_of(params, mb):
        if mixed_precision:
            params = tree_util.tree_map(
                lambda p: p.to(torch.bfloat16) if p.is_floating_point()
                else p, params)
        return value_and_grad(model, params, mb, remat=remat, unroll=unroll)

    def step(params: PyTree, opt_state: AdamWState,
             batch: Dict[str, torch.Tensor]):
        if micro_batches == 1:
            (loss, metrics), grads = grad_of(params, batch)
        else:
            M = micro_batches
            split = {k: x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            gacc = tree_util.tree_map(
                lambda p: torch.zeros(tuple(p.shape), dtype=torch.float32,
                                      device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            for i in range(M):
                (l, metrics), g = grad_of(params,
                                          {k: x[i] for k, x in split.items()})
                gacc = tree_util.tree_map(lambda a, b: a + b.float(), gacc, g)
                lsum = lsum + l
            grads = tree_util.tree_map(lambda g: g / M, gacc)
            loss = lsum / M
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params,
                                                    donate=donate)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


class TrainLoop:
    """Checkpointed, preemption-safe host loop.  Batches (numpy) go to the
    model's device."""

    def __init__(self, model, opt: AdamW, *, step_fn=None,
                 checkpointer=None, ckpt_every: int = 100,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.opt = opt
        self.step_fn = step_fn or make_train_step(model, opt)
        self.checkpointer = checkpointer
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self._preempted = False
        self._old_handlers: Dict[int, Any] = {}

    def install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._old_handlers[sig] = signal.signal(sig, handler)

    def restore_signal_handlers(self):
        """Put back the handlers :meth:`install_signal_handler` replaced."""
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()

    def run(self, params: PyTree, opt_state: AdamWState,
            batches: Iterator[Dict[str, np.ndarray]], *,
            start_step: int = 0, n_steps: int = 100
            ) -> Tuple[PyTree, AdamWState, Dict[str, list]]:
        history: Dict[str, list] = {"loss": [], "step": [], "tps": []}
        device = self.model.device
        t_last = time.monotonic()
        step = start_step
        for step in range(start_step, start_step + n_steps):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(batches).items()}
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            if (step + 1) % self.log_every == 0 or step == start_step:
                loss = float(metrics["loss"])          # waits for the step
                now = time.monotonic()
                tokens = batch["labels"].numel() * self.log_every
                tps = tokens / max(now - t_last, 1e-9)
                t_last = now
                history["loss"].append(loss)
                history["step"].append(step + 1)
                history["tps"].append(tps)
                self.log(f"step {step + 1:5d}  loss {loss:.4f}  "
                         f"tok/s {tps:,.0f}")
            if self.checkpointer is not None and \
                    ((step + 1) % self.ckpt_every == 0 or self._preempted):
                self.checkpointer.save(step + 1, params, opt_state)
            if self._preempted:
                self.log(f"preempted at step {step + 1}: checkpoint saved, "
                         "exiting cleanly")
                break
        return params, opt_state, history
