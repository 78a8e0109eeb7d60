"""Torch oracles of the kernels this port carries: the semantic
definitions, small and obviously correct (O(S^2) memory where that is the
honest definition).  Each mirrors its counterpart in the JAX package's
``kernels/ref.py`` operation for operation, so the two can be held
against each other on the same inputs.

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


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Block-paged decode attention: gather-then-attend oracle.

    q: (B, H, dh); k_pages/v_pages: (P, K, pt, dh) physical page pools
    shared across the batch; tables: (B, NP) int page ids per row
    (logical extent NP * pt); pos: (B,).  Per row, its NP pages are
    gathered into the contiguous logical cache and :func:`decode_attention`
    runs on it, so masking, windows and GQA are the slotted oracle's.
    """
    B = q.shape[0]
    K, pt, dh = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    NP = tables.shape[1]
    idx = tables.long()
    kc = k_pages[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    vc = v_pages[idx].transpose(1, 2).reshape(B, K, NP * pt, dh)
    return decode_attention(q, kc, vc, pos, window=window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
        return_state: bool = False):
    """Naive sequential SSD recurrence (the definition).

    x:  (b, nh, S, dp)   inputs per head
    dt: (b, nh, S)       positive step sizes (softplus already applied)
    A:  (nh,)            negative decay rates (A = -exp(A_log))
    B:  (b, S, N)        input projections (ngroups=1, shared over heads)
    C:  (b, S, N)        output projections
    h0: (b, nh, dp, N)   optional initial state
    Recurrence per head:  h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t B_t^T
                          y_t = h_t C_t   (D skip applied by the caller)
    Returns y (b, nh, S, dp) in x's dtype [, h_S (b, nh, dp, N) f32].
    """
    b, nh, S, dp = x.shape
    N = B.shape[-1]
    h = (torch.zeros((b, nh, dp, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, :, t] * Af[None, :])             # (b, nh)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, :, t], xf[:, :, t],
                           Bf[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = (torch.stack(ys, dim=2) if ys else
         torch.zeros((b, nh, 0, dp), device=x.device)).to(x.dtype)
    if return_state:
        return y, h
    return y


def rglru(a: torch.Tensor, b: torch.Tensor, *,
          h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """h_t = a_t * h_{t-1} + b_t, elementwise over the width dim.

    a, b: (B, S, W); h0: (B, W).  Returns h at every step (B, S, W) in
    a's dtype [, h_S (B, W) f32].  (The gates -- r_t, i_t, the
    sqrt(1-a^2) input scale -- are the model's; this is the pure
    first-order linear recurrence.)
    """
    Bsz, S, W = a.shape
    h = (torch.zeros((Bsz, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    ys = []
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bsz, 0, W), device=a.device)).to(a.dtype)
    if return_state:
        return y, h
    return y


def weight_transform(w: torch.Tensor, scale: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Dequantize / cast a stored weight to its compute representation.

    w: (n, m) int8 (quantized, with per-column f32 ``scale`` (m,)) or any
    float dtype (scale None -> pure cast).
    """
    if scale is not None:
        return (w.float() * scale[None, :].float()).to(out_dtype)
    return w.to(out_dtype)


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dequant-then-matmul, the definition the fused kernel must match:
    the f32 weight exactly as the dequant-at-load path makes it
    (:func:`weight_transform`), contracted in f32.

    x: (m, k) any float dtype; w: (k, n) int8; scale: (n,) f32 per
    column.  Returns (m, n) in ``out_dtype`` (default x.dtype).
    """
    wf = w.float() * scale[None, :].float()
    return (x.float() @ wf).to(out_dtype or x.dtype)
