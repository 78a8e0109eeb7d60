"""Building blocks of the dense LM: norms, RoPE, GQA attention (full or
sliding window), SwiGLU / GELU MLPs, embedding and head.

Parameters are plain dicts of tensors in the reference's layouts
(``wq (d, H, dh)``, ``wo (H, dh, d)``, ``tok (V, d)``, caches
``(B, K, S_max, dh)``); every function is a plain function on tensors.
Attention goes through :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

PyTree = Any


# ---------------------------------------------------------------------------
# initializers (the "PISeL-faithful" expensive construction path)
# ---------------------------------------------------------------------------

def dense_init_(t: torch.Tensor, gen: torch.Generator,
                fan_in: Optional[int] = None) -> torch.Tensor:
    """He/Kaiming-style normal init in place — deliberately the *real*
    numerical initialization the paper's MiniLoader elides."""
    fan = fan_in if fan_in is not None else t.shape[0]
    std = math.sqrt(2.0 / max(fan, 1))
    return t.normal_(0.0, std, generator=gen)


def embed_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    return t.normal_(0.0, 0.02, generator=gen)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    if cfg.norm == "rmsnorm":
        return {"scale": (cfg.d_model,)}
    return {"scale": (cfg.d_model,), "bias": (cfg.d_model,)}


def norm_init_(cfg, p: Dict[str, torch.Tensor]):
    """rmsnorm scales start at 0 (the ``1 + scale`` form); layernorm at
    scale 1, bias 0."""
    if cfg.norm == "rmsnorm":
        p["scale"].zero_()
    else:
        p["scale"].fill_(1.0)
        p["bias"].zero_()


def apply_norm(cfg, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE (split-half)
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].float() * freqs                # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA, optional sliding window)
# ---------------------------------------------------------------------------

def attn_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {"wq": (d, h, dh), "wk": (d, k, dh), "wv": (d, k, dh),
            "wo": (h, dh, d)}


def attn_init_(cfg, p: Dict[str, torch.Tensor], gen: torch.Generator):
    d = cfg.d_model
    for name in ("wq", "wk", "wv"):
        dense_init_(p[name], gen, fan_in=d)
    dense_init_(p["wo"], gen, fan_in=cfg.n_heads * cfg.dh)


def _project(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """x (B, S, d) @ w (d, *out) -> (B, S, *out), contiguous, in ``cd``."""
    d = w.shape[0]
    y = x.reshape(-1, d) @ w.to(cd).reshape(d, -1)
    return y.reshape(x.shape[:-1] + w.shape[1:])


def qkv_project(cfg, p: PyTree, x: torch.Tensor, positions: torch.Tensor,
                *, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,K,dh)."""
    cd = cfg.compute_dtype
    x = x.to(cd)
    q = _project(x, p["wq"], cd)
    k = _project(x, p["wk"], cd)
    v = _project(x, p["wv"], cd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg, p: PyTree, o: torch.Tensor) -> torch.Tensor:
    """o: (B, S, H, dh) -> (B, S, D)."""
    cd = cfg.compute_dtype
    wo = p["wo"]
    hd = wo.shape[0] * wo.shape[1]
    y = o.to(cd).reshape(-1, hd) @ wo.to(cd).reshape(hd, -1)
    return y.reshape(o.shape[:2] + (wo.shape[2],))


def attention_block(cfg, p: PyTree, x: torch.Tensor, positions: torch.Tensor,
                    *, window: int = -1, return_kv: bool = False):
    """Self-attention sub-block (no residual, no norm).

    window: -1 -> use cfg.sliding_window; 0 -> full; >0 -> that window.
    return_kv: also return the rotated (k, v) for prefill cache writes.
    """
    if window < 0:
        window = cfg.sliding_window
    q, k, v = qkv_project(cfg, p, x, positions)
    o = ops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    y = attn_out(cfg, p, o)
    if return_kv:
        return y, k, v
    return y


def attention_decode(cfg, p: PyTree, x: torch.Tensor, pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     *, window: int = -1):
    """Single-token decode.  x: (B, 1, D); caches: (B, K, S_max, dh)
    kv-head-major; pos: (B,) int32 current position.  Returns
    (y, k_cache, v_cache).

    The reference rewrites the whole cache with a mask-select
    (``jnp.where`` over a one-hot of the slot) because JAX arrays are
    immutable; here the new K/V row is written into the caches *in place*
    (``k_cache[b, :, slot] = k``), so the returned caches are the same
    tensors that were passed in.
    """
    if window < 0:
        window = cfg.sliding_window
    q, k, v = qkv_project(cfg, p, x, pos[:, None])
    s_max = k_cache.shape[2]
    slot = (pos % s_max) if window > 0 else pos               # ring buffer
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = slot.long()
    k_cache[rows, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, :, slot] = v[:, 0].to(v_cache.dtype)
    o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, pos,
                             window=window)
    y = attn_out(cfg, p, o[:, None])
    return y, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_shapes(cfg, d_ff: Optional[int] = None) -> Dict[str, Tuple[int, ...]]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("silu", "geglu"):                          # gated
        return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    return {"wu": (d, f), "wd": (f, d)}


def mlp_init_(cfg, p: Dict[str, torch.Tensor], gen: torch.Generator):
    for name in ("wg", "wu"):
        if name in p:
            dense_init_(p[name], gen)
    dense_init_(p["wd"], gen, fan_in=p["wd"].shape[0])


def mlp_block(cfg, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = x.to(cd)
    if cfg.act in ("silu", "geglu"):
        g = _project(x, p["wg"], cd)
        u = _project(x, p["wu"], cd)
        act = F.silu if cfg.act == "silu" else \
            (lambda t: F.gelu(t, approximate="tanh"))
        h = act(g) * u
    else:
        h = F.gelu(_project(x, p["wu"], cd), approximate="tanh")
    return _project(h, p["wd"], cd)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_lookup(cfg, p: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    # gather then cast: elementwise, so equal to the reference's
    # cast-then-gather without casting the whole table
    return p["tok"][tokens].to(cfg.compute_dtype)


def head_logits(cfg, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Final-norm output (B, S, d) -> logits (B, S, V); tied heads
    contract the embedding table, softcap when configured."""
    cd = cfg.compute_dtype
    x = x.to(cd)
    if cfg.tie_embeddings and not cfg.is_encoder:
        w = params["embed"]["tok"].to(cd)
        logits = x @ w.t()
    else:
        logits = _project(x, params["final"]["head"]["w"], cd)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
