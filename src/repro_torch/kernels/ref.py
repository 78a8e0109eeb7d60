"""Torch oracles of the kernels this port carries: the semantic
definitions, small and obviously correct (O(S^2) memory where that is the
honest definition).  Each mirrors its counterpart in the JAX package's
``kernels/ref.py`` operation for operation, so the two can be held
against each other on the same inputs.

The oracles of ``decode_attention_paged``, ``ssd``, ``rglru`` and
``quant_matmul`` come with their kernels (ROADMAP queue 2).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive full-materialization attention.

    q: (B, H, S, dh); k, v: (B, K, T, dh) with H a multiple of K (GQA).
    window: 0 -> full; >0 -> sliding window of that many positions
    (a query at i attends to keys in (i-window, i]).
    Returns (B, H, S, dh), same dtype as q.
    """
    B, H, S, dh = q.shape
    K, T = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", qf, kf) / math.sqrt(dh)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        # queries are the *last* S positions of the T-long key sequence
        offs = T - S
        mask &= ki <= (qi + offs)
        if window > 0:
            mask &= ki > (qi + offs - window)
    elif window > 0:
        mask &= (ki - qi).abs() < window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p, vf)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode against a (possibly ring-buffered) KV cache.

    q: (B, H, dh) — the single new query (already rotated).
    k_cache/v_cache: (B, K, S_max, dh) — kv-head-major layout.
    pos: (B,) int — index of the *current* token (its K/V entry is
         already in the cache).
    window: 0 -> valid slots are [0, pos]; >0 -> ring buffer of
         S_max == window slots, slot j holds the position p with
         p % window == j; valid iff p in (pos-window, pos].
    Returns (B, H, dh).
    """
    B, H, dh = q.shape
    K, S_max = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    # the dots accumulate in f32 over the stored dtype, as the JAX
    # oracle's preferred_element_type=f32 does
    qr = q.reshape(B, K, rep, dh).float()
    scores = torch.einsum("bkrd,bksd->bkrs", qr,
                          k_cache.float()) / math.sqrt(dh)
    idx = torch.arange(S_max, device=q.device)[None, :]
    cur = pos.to(torch.int64)[:, None]
    if window > 0:
        p_at_slot = cur - torch.remainder(cur - idx, window)
        valid = (p_at_slot >= 0) & (p_at_slot > cur - window)
    else:
        valid = idx <= cur
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrs,bksd->bkrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, dh).to(q.dtype)


def weight_transform(w: torch.Tensor, scale: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Dequantize / cast a stored weight to its compute representation.

    w: (n, m) int8 (quantized, with per-column f32 ``scale`` (m,)) or any
    float dtype (scale None -> pure cast).
    """
    if scale is not None:
        return (w.float() * scale[None, :].float()).to(out_dtype)
    return w.to(out_dtype)
