"""Gradient compression for the data-parallel reduce: int8 with error
feedback (the port of ``repro.distributed.compression``).

Int8 quantization cuts the bytes of the DP gradient reduce 4x; **error
feedback** (Karimireddy et al.) accumulates the quantization residual
locally and re-injects it next step, which restores convergence to the
uncompressed trajectory asymptotically.

Two entry points:

  * ``make_error_feedback_transform`` — a ``grad_transform`` hook for
    the optimizer (models the compress->reduce->decompress round trip;
    usable on any device count);
  * ``compressed_psum`` — the collective itself, over a
    ``torch.distributed`` process group: quantize, all-gather the int8
    values and the scales, dequantize and mean.  4x fewer bytes on the
    wire than an f32 all-reduce ring.  (The reference's is a shard_map
    collective over a mesh axis.)
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale), scale an f32
    scalar; bit-equal to the reference's (f32 division, round half to
    even)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: PyTree) -> PyTree:
    return tree_util.tree_map(
        lambda l: torch.zeros(tuple(l.shape), dtype=torch.float32,
                              device=l.device), params)


def make_error_feedback_transform() -> Callable:
    """Returns f(grads, ef) -> (compressed_grads, new_ef).

    compressed = dequant(quant(g + ef));  new_ef = (g + ef) - compressed.
    """
    def f(grads: PyTree, ef: PyTree) -> Tuple[PyTree, PyTree]:
        comp, new_ef = {}, {}
        named = tree_util.leaves_with_path(grads)
        efs = dict(("/".join(p), e) for p, e in tree_util.leaves_with_path(ef))
        for path, g in named:
            n = "/".join(path)
            corrected = g.float() + efs[n]
            q, s = quantize_int8(corrected)
            deq = dequantize_int8(q, s)
            comp[n] = deq.to(g.dtype)
            new_ef[n] = corrected - deq
        return (tree_util.unflatten(grads, comp),
                tree_util.unflatten(ef, new_ef))
    return f


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean-reduce ``x`` over the processes of ``group`` (default: the
    world) with an int8 wire format: all-gather the int8 values and the
    f32 scales, dequantize each, mean over processes.  Returns f32."""
    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty(1, dtype=torch.float32, device=x.device)
              for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(scales, scale.reshape(1), group=group)
    deq = torch.stack(qs).float() * torch.cat(scales).reshape(
        (-1,) + (1,) * q.dim())
    return deq.mean(dim=0)


def compressed_psum_tree(grads: PyTree, group=None) -> PyTree:
    return tree_util.tree_map(
        lambda g: compressed_psum(g, group).to(g.dtype), grads)
