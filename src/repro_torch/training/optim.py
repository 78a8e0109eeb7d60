"""AdamW optimizer + schedules over trees of tensors (the port of
``repro.training.optim``; no optimizer library).

Supports global-norm gradient clipping, decoupled weight decay,
warmup-cosine LR, and (for the distributed path) an optional gradient
transform hook — the int8 error-feedback compressor plugs in there.
The moments ``m`` and ``v`` are f32 and ``step`` is an int32 scalar, on
the params' device; an update builds new tensors, as the reference's
pure function does.  Decay applies where ``p.ndim >= 2`` of the stacked
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

    def update(self, grads: PyTree, state: AdamWState, params: PyTree
               ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
        step = state.step + 1
        gnorm = global_norm(grads)
        # the moments take f32 gradients (JAX's g * scale promotes a bf16
        # gradient to f32 as well)
        grads = tree_util.tree_map(lambda g: g.float(), grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_util.tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree_util.tree_map(lambda mm, g: b1 * mm + (1 - b1) * g,
                               state.m, grads)
        v = tree_util.tree_map(lambda vv, g: b2 * vv + (1 - b2) * g.square(),
                               state.v, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self._lr(step)

        def upd(p, mm, vv):
            mhat = mm / bc1
            vhat = vv / bc2
            u = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay > 0 and p.dim() >= 2:   # decay matrices only
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_util.tree_map(upd, params, m, v)
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
