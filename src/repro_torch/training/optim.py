"""AdamW optimizer + schedules over trees of tensors (the port of
``repro.training.optim``; no optimizer library).

Supports global-norm gradient clipping, decoupled weight decay,
warmup-cosine LR, and (for the distributed path) an optional gradient
transform hook — the int8 error-feedback compressor plugs in there.
The moments ``m`` and ``v`` are f32 and ``step`` is an int32 scalar, on
the params' device; an update builds new tensors, as the reference's
pure function does, or with ``donate=True`` writes the same values into
the params and moments it was given (the buffer donation of a jitted
step: the caller gives up the old ones, and the step holds one copy of the
state instead of two).  Decay applies where ``p.ndim >= 2`` of the stacked
tree, so the stacked norm scales ``(n_units, d)`` decay and the tail's do
not, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_util

PyTree = Any
# elements of a leaf a donated update takes at once: its temporaries stay
# near 64 MB each, where a whole leaf's would be up to 3.9 GiB (internvl2's
# embedding and head)
DONATE_CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: PyTree
    v: PyTree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: PyTree) -> AdamWState:
        leaves = tree_util.leaves(params)
        device = leaves[0].device if leaves else None

        def zeros(p):
            return tree_util.tree_map(
                lambda l: torch.zeros(tuple(l.shape), dtype=torch.float32,
                                      device=l.device), p)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros(params), zeros(params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads: PyTree, state: AdamWState, params: PyTree, *,
               donate: bool = False
               ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
        """One step.  ``donate``: write the new params and moments into
        ``params`` and ``state``'s tensors, leaf by leaf, with the same
        operations (so the same bits), and return them."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm > 0 else None)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def grad(g):
            # the moments take f32 gradients (JAX's g * scale promotes a
            # bf16 gradient to f32 as well)
            g = g.float()
            return g * scale if scale is not None else g

        def first(mm, g):
            return b1 * mm + (1 - b1) * g

        def second(vv, g):
            return b2 * vv + (1 - b2) * g.square()

        def upd(p, mm, vv, decay: bool):
            mhat = mm / bc1
            vhat = vv / bc2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        def decays(p) -> bool:                  # matrices only
            return self.weight_decay > 0 and p.dim() >= 2

        if donate:
            # every operation is elementwise, so a leaf taken in flat
            # chunks gives the same bits as the whole leaf
            for p, mm, vv, g in zip(tree_util.leaves(params),
                                    tree_util.leaves(state.m),
                                    tree_util.leaves(state.v),
                                    tree_util.leaves(grads)):
                decay = decays(p)
                flat = [t.view(-1) for t in (p, mm, vv)] + [g.reshape(-1)]
                for lo in range(0, p.numel(), DONATE_CHUNK):
                    pc, mc, vc, gc = (t[lo:lo + DONATE_CHUNK] for t in flat)
                    gc = grad(gc)
                    mc.copy_(first(mc, gc))
                    vc.copy_(second(vc, gc))
                    pc.copy_(upd(pc, mc, vc, decay))
            return params, AdamWState(step, state.m, state.v), \
                {"grad_norm": gnorm, "lr": lr}
        grads = tree_util.tree_map(grad, grads)
        m = tree_util.tree_map(first, state.m, grads)
        v = tree_util.tree_map(second, state.v, grads)
        new_params = tree_util.tree_map(
            lambda p, mm, vv: upd(p, mm, vv, decays(p)), params, m, v)
        return new_params, AdamWState(step, m, v), \
            {"grad_norm": gnorm, "lr": lr}


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's sum of squares in f32."""
    total = 0
    for leaf in tree_util.leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return sched
