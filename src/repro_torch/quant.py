"""Quantized-resident weight leaves (``compute_quant``), a port of
``repro.quant``.

Under ``compute_quant`` the cold start keeps each int8 leaf of the store
resident as a :class:`QuantLeaf` — the int8 values at the leaf's logical
shape plus its per-column f32 scale over the last axis — instead of
dequantizing it at A, so the params hold about a quarter of the f32
bytes and every weight contraction goes through the fused-dequant
``quant_matmul`` kernel (:func:`einsum`).

:class:`QuantLeaf` is a node of :mod:`repro_torch.tree` with two
children: ``tree_map`` (and with it the stacking in ``LM.assemble`` and
the per-layer indexing of the stacked blocks) acts on ``q`` and
``scale`` alike, while ``leaves_with_path`` yields it as one leaf under
the store's leaf name.  ``.shape`` mirrors the logical leaf, so
structural checks against the abstract tree still pass; ``.astype``
dequantizes, bit-equal to the plain ``weight_transform``.
:func:`expert_einsum` runs the MoE experts' per-expert contractions.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import ops


@tree_util.register_node
class QuantLeaf:
    """One int8-resident weight: values at the logical leaf shape,
    per-column f32 scales over the last axis."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def tree_children(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.q, self.scale

    @classmethod
    def tree_rebuild(cls, children) -> "QuantLeaf":
        return cls(*children)

    # -- logical-tensor surface ---------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        """Resident bytes: int8 values + f32 scales (~quarter of f32)."""
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def astype(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize to ``dtype``: f32 multiply, then cast (bit-equal to
        ``ref.weight_transform``)."""
        return (self.q.float() * self.scale.float()).to(dtype)

    def record_stream(self, stream):
        self.q.record_stream(stream)
        self.scale.record_stream(stream)

    def __repr__(self):
        return (f"QuantLeaf(shape={self.shape}, "
                f"scale={tuple(self.scale.shape)})")


def is_quant(leaf) -> bool:
    return isinstance(leaf, QuantLeaf)


def einsum(x: torch.Tensor, w, cd: torch.dtype, *,
           n_contract: int = 1) -> torch.Tensor:
    """Contract the trailing ``n_contract`` axes of ``x`` with the leading
    ``n_contract`` axes of the weight ``w``; the remaining weight axes
    are output axes.  Returns ``x.shape[:-n_contract] + w.shape[n_contract:]``
    in ``cd``.

    A plain tensor weight is cast to ``cd`` and multiplied.  A
    :class:`QuantLeaf` goes through ``ops.quant_matmul``: its scale lies
    over the weight's last axis, so with middle output axes (``wq``
    ``(d, H, dh)``: scale ``(dh,)``) it is tiled ``N // last`` times —
    column ``j`` of the collapsed ``(K, N)`` weight is ``(j // last,
    j % last)`` row-major."""
    kdims = tuple(w.shape[:n_contract])
    ndims = tuple(w.shape[n_contract:])
    K, N = math.prod(kdims), math.prod(ndims)
    lead = x.shape[:x.dim() - n_contract]
    x2 = x.to(cd).reshape(-1, K)
    if isinstance(w, QuantLeaf):
        reps = N // w.scale.shape[-1]
        scale = w.scale.repeat(reps) if reps > 1 else w.scale
        y = ops.quant_matmul(x2, w.q.reshape(K, N), scale, out_dtype=cd)
    else:
        y = x2 @ w.to(cd).reshape(K, N)
    return y.reshape(lead + ndims)


def expert_einsum(x: torch.Tensor, w, cd: torch.dtype, *,
                  shared_x: bool = False) -> torch.Tensor:
    """Per-expert contraction of the reference's ``becd,edf->becf`` (and
    its ``wd`` twin ``becf,efd->becd``): ``x`` (B, E, C, k) against ``w``
    (E, k, n) gives (B, E, C, n) in ``cd``.  ``shared_x``: every expert
    sees the same activations ``x`` (B, S, k) (the dense oracle's
    ``bsd,edf->besf``).

    One 2-D product per expert, in expert order, for a plain weight and a
    :class:`QuantLeaf` alike; a ``QuantLeaf`` launches one
    ``ops.quant_matmul`` per expert over ``w.q[e]``, with the scale (over
    the last axis) shared by all experts."""
    E, K, N = w.shape
    outs = []
    for e in range(E):
        xe = x if shared_x else x[:, e]
        x2 = xe.to(cd).reshape(-1, K)
        if isinstance(w, QuantLeaf):
            y = ops.quant_matmul(x2, w.q[e], w.scale, out_dtype=cd)
        else:
            y = x2 @ w[e].to(cd)
        outs.append(y.reshape(xe.shape[:-1] + (N,)))
    return torch.stack(outs, dim=1)


def dequant(w, cd: torch.dtype) -> torch.Tensor:
    """A whole weight in ``cd`` for a product at its use (the reference's
    ``w.astype(cd)``).  A plain tensor is cast; a :class:`QuantLeaf` is
    dequantized by ``ops.weight_transform`` over its ``(-1, last)`` view,
    bit-equal to :meth:`QuantLeaf.astype` and the hand-written kernel on
    the card.  Mamba-2's projections and the tied heads take this route:
    the reference does not run them through ``quant_matmul``."""
    if not isinstance(w, QuantLeaf):
        return w.to(cd)
    n = w.shape[-1]
    return ops.weight_transform(w.q.reshape(-1, n), w.scale,
                                out_dtype=cd).reshape(w.shape)


def gather_rows(w, idx: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Embedding lookup ``w[idx]`` in ``cd``.  For a :class:`QuantLeaf`
    the int8 rows are gathered, then scaled (elementwise, so equal bit
    for bit to dequantizing the whole table first)."""
    if not isinstance(w, QuantLeaf):
        return w[idx].to(cd)
    return (w.q[idx].float() * w.scale.float()).to(cd)
