"""Mixture-of-Experts FFN of the port (Mixtral 8x7B; Arctic's 128 experts
with a dense residual), after ``repro.models.moe``.

Gather-based dispatch, routed per batch row:

  1. router logits (f32) -> softmax -> top-k experts per token;
  2. per (row, expert): the top-C tokens by routing weight
     (C = ceil(k*S/E * capacity_factor)); capacity overflow drops the
     lowest-weight tokens;
  3. gather the token activations (B, E, C, d);
  4. the experts' SwiGLU products, one 2-D product per expert
     (:func:`repro_torch.quant.expert_einsum`);
  5. weighted combine back onto the token positions.

Unassigned capacity slots carry routing weight exactly 0, so their
contribution vanishes.  The reference's sharding hints (``constrain``)
have nothing to do on one device and are dropped.

Both selections break ties by the lower index, as ``jax.lax.top_k``
does (:func:`top_k`: a stable descending sort; ``torch.topk`` promises no
order among equal values on CUDA, and the unassigned tokens' zero weights
tie in bulk).  The combine adds the experts in index order, one
non-accumulating write per expert (a row's top-C tokens of one expert are
distinct), so its bits never depend on the order of atomics.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import quant
from repro_torch.models import layers

PyTree = Any


def moe_shapes(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    out: Dict[str, Any] = {"router": (d, E),
                           "experts": {"wg": (E, d, f), "wu": (E, d, f),
                                       "wd": (E, f, d)}}
    if cfg.dense_residual:
        out["dense"] = layers.mlp_shapes(cfg)
    return out


def moe_init_(cfg, p: PyTree, gen: torch.Generator):
    """The reference's ``moe_params`` init rules: the router with fan-in
    d, the experts' wg / wu with fan-in d and wd with fan-in f, then the
    dense residual MLP."""
    d = cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    layers.dense_init_(p["router"], gen)
    ex = p["experts"]
    layers.dense_init_(ex["wg"], gen, fan_in=d)
    layers.dense_init_(ex["wu"], gen, fan_in=d)
    layers.dense_init_(ex["wd"], gen, fan_in=f)
    if "dense" in p:
        layers.mlp_init_(cfg, p["dense"], gen)


def capacity(cfg, seq: int) -> int:
    c = math.ceil(cfg.top_k * seq / cfg.n_experts * cfg.capacity_factor)
    return max(1, min(c, seq))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values over the last axis and their indices,
    largest first and the lower index first among equal values (the
    order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# rows of the router's logits computed at once (see _router_logits)
ROUTER_ROWS = 64


def _router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 (x (..., d), w (d, E)) whose rows never depend on
    the batch: elementwise products, summed over d as a pairwise tree of
    elementwise adds (d zero-padded to a power of two), ROUTER_ROWS rows
    at a time.  A cuBLAS product picks its f32 algorithm by the row
    count, and at mixtral's width a row's logits at M = 4 differed in
    their last bits from the same row at M = 1 (the rows probe of
    ``kernels/ab.py``): enough to flip an expert choice at a near-tie
    between the scheduler's batched step and the serial reference."""
    lead, d = x.shape[:-1], x.shape[-1]
    n = 1 << (d - 1).bit_length()
    x2 = F.pad(x.reshape(-1, d), (0, n - d))
    w2 = F.pad(w, (0, 0, 0, n - d))
    outs = []
    for i in range(0, x2.shape[0], ROUTER_ROWS):
        t = x2[i:i + ROUTER_ROWS, :, None] * w2              # (r, n, E)
        while t.shape[1] > 1:
            h = t.shape[1] // 2
            t = t[:, :h] + t[:, h:]
        outs.append(t[:, 0])
    return torch.cat(outs).reshape(lead + (w.shape[-1],))


def route(cfg, router_w, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (weights (B, S, E) sparse top-k, probs (B, S, E),
    topk mask (B, S, E)).  An int8-resident router dequantizes (f32
    multiply, then the cast), as the reference's ``.astype`` does."""
    w = (router_w.astype(torch.float32) if quant.is_quant(router_w)
         else router_w.float())
    logits = _router_logits(x.float(), w)
    probs = torch.softmax(logits, dim=-1)
    vals, eidx = top_k(probs, cfg.top_k)                     # (B, S, k)
    vals = vals / vals.sum(dim=-1, keepdim=True)             # renormalize
    oh = F.one_hot(eidx, cfg.n_experts).float()              # (B, S, k, E)
    w_te = torch.einsum("bsk,bske->bse", vals, oh)           # sparse weights
    mask = oh.sum(dim=2)                                     # (B, S, E) 0/1
    return w_te, probs, mask


def load_balance_loss(probs: torch.Tensor, mask: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    f_e = mask.mean(dim=(0, 1))                              # dispatch share
    p_e = probs.mean(dim=(0, 1))                             # mean router prob
    return n_experts * (f_e * p_e).sum()


def _swiglu_experts(cfg, we: PyTree, x: torch.Tensor,
                    shared_x: bool = False) -> torch.Tensor:
    cd = cfg.compute_dtype
    h_g = quant.expert_einsum(x, we["wg"], cd, shared_x=shared_x)
    h_u = quant.expert_einsum(x, we["wu"], cd, shared_x=shared_x)
    return quant.expert_einsum(F.silu(h_g) * h_u, we["wd"], cd)


def moe_block(cfg, p: PyTree, x: torch.Tensor, *, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d).  Returns (y (B, S, d) in the compute dtype, aux loss
    (f32 scalar; None unless ``with_aux``)).  The aux loss is the one
    quantity of the block taken over the whole batch; the decode and
    prefill paths, which drop it as the reference's do, skip it, so a
    decode step holds no op whose result depends on the batch (the rows
    probe of ``kernels/ab.py`` reports such an op)."""
    B, S, d = x.shape
    E = cfg.n_experts
    C = capacity(cfg, S)
    cd = cfg.compute_dtype

    w_te, probs, mask = route(cfg, p["router"], x)
    aux = load_balance_loss(probs, mask, E).float() if with_aux else None

    # per (row, expert) the top-C tokens by weight
    g, idx = top_k(w_te.transpose(1, 2), C)                  # (B, E, C)
    rows = torch.arange(B, device=x.device)[:, None, None]
    x_e = x[rows, idx]                                       # (B, E, C, d)

    y_e = _swiglu_experts(cfg, p["experts"], x_e)
    y_e = y_e * g[..., None].to(cd)                          # 0 if unassigned

    # combine: the experts in index order; one expert's C tokens of a row
    # are distinct, so each write is a plain (non-accumulating) one
    out = torch.zeros((B, S, d), dtype=cd, device=x.device)
    rows = rows[:, 0]                                        # (B, 1)
    for e in range(E):
        at = idx[:, e]                                       # (B, C)
        out[rows, at] = out[rows, at] + y_e[:, e]

    if cfg.dense_residual:
        out = out + layers.mlp_block(cfg, p["dense"], x)
    return out, aux


def moe_block_dense_ref(cfg, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert on every token, combined with the exact top-k
    weights, no capacity limit (E/k times the work; tests only)."""
    cd = cfg.compute_dtype
    w_te, _, _ = route(cfg, p["router"], x)                  # (B, S, E)
    y_e = _swiglu_experts(cfg, p["experts"], x, shared_x=True)  # (B,E,S,d)
    out = torch.einsum("bse,besd->bsd", w_te.to(cd), y_e)
    if cfg.dense_residual:
        out = out + layers.mlp_block(cfg, p["dense"], x)
    return out
