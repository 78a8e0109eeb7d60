"""Building blocks of the LMs: norms, RoPE, GQA attention (full or
sliding window), SwiGLU / GELU MLPs, the causal depthwise conv of the
recurrent blocks, embedding and head.

Parameters are plain dicts of tensors in the reference's layouts
(``wq (d, H, dh)``, ``wo (H, dh, d)``, ``tok (V, d)``, caches
``(B, K, S_max, dh)``, page pools ``(P, K, pt, dh)``); every function is
a plain function on tensors.  A weight may be a ``quant.QuantLeaf``
(``compute_quant``): its contractions go through ``quant.einsum`` and
its embedding rows through ``quant.gather_rows``.  Attention and the
int8 products go through :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import quant
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
    """The reference's rmsnorm; on the GPU a kernel whose rows do not
    depend on the batch (``kernels/rmsnorm.py``)."""
    return ops.rmsnorm(x, scale, eps)


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


def qkv_project(cfg, p: PyTree, x: torch.Tensor, positions: torch.Tensor,
                *, rope: bool = True):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,K,dh)."""
    cd = cfg.compute_dtype
    x = x.to(cd)
    q = quant.einsum(x, p["wq"], cd)
    k = quant.einsum(x, p["wk"], cd)
    v = quant.einsum(x, p["wv"], cd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(cfg, p: PyTree, o: torch.Tensor) -> torch.Tensor:
    """o: (B, S, H, dh) -> (B, S, D)."""
    return quant.einsum(o, p["wo"], cfg.compute_dtype, n_contract=2)


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


def attention_decode_paged(cfg, p: PyTree, x: torch.Tensor,
                           pos: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor):
    """Single-token decode through a block-paged KV pool.

    x: (B, 1, D); k_pages/v_pages: (P, K, pt, dh) physical pools shared
    across the batch; tables: (B, NP) int32 page ids per row; pos: (B,)
    int32 current position.  Row b's token is written, in place, at page
    ``tables[b, pos // pt]``, row ``pos % pt``: a B-row scatter, so the
    cost follows the batch, not the pool.  Live rows never collide (each
    owns its write page); inactive rows carry tables full of the scratch
    page, so their writes (duplicate indices, any writer wins) land there
    and are never read — the kernel masks positions past ``pos`` exactly
    and live tables never reference scratch below ``pos``.
    Returns (y, k_pages, v_pages).
    """
    q, k, v = qkv_project(cfg, p, x, pos[:, None])
    pt = k_pages.shape[2]
    pl = pos.long()
    pg = tables.long().gather(1, (pl // pt)[:, None])[:, 0]
    row = pl % pt
    k_pages[pg, :, row] = k[:, 0].to(k_pages.dtype)
    v_pages[pg, :, row] = v[:, 0].to(v_pages.dtype)
    o = ops.decode_attention_paged(q[:, 0].contiguous(), k_pages, v_pages,
                                   tables, pos)
    y = attn_out(cfg, p, o[:, None])
    return y, k_pages, v_pages


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU as the reference computes it
    (``jax.nn.gelu``): op by op in x's dtype, its constants rounded to
    that dtype, so that bf16 rounds where it does there (``F.gelu``
    rounds once, and differs from it in about 40% of bf16 outputs)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_block(cfg, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    cd = cfg.compute_dtype
    x = x.to(cd)
    if cfg.act in ("silu", "geglu"):
        g = quant.einsum(x, p["wg"], cd)
        u = quant.einsum(x, p["wu"], cd)
        act = F.silu if cfg.act == "silu" else gelu
        h = act(g) * u
    else:
        h = gelu(quant.einsum(x, p["wu"], cd))
    return quant.einsum(h, p["wd"], cd)


# ---------------------------------------------------------------------------
# causal depthwise conv (Mamba-2 / Griffin temporal conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, kernel, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, C); kernel: (W, C); state:
    (B, W-1, C) prefix carried across calls (None -> zeros).  Returns
    (y (B, S, C) in x's dtype, new_state (B, W-1, C)); the taps
    accumulate in f32."""
    B, S, C = x.shape
    if quant.is_quant(kernel):           # conv taps are tiny: dequant whole
        kernel = kernel.astype(torch.float32)
    W = kernel.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                         # (B, S+W-1, C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xp[:, i:i + S].float() * kernel[i].float()
    new_state = xp[:, S:] if W > 1 else xp[:, :0]
    return y.to(x.dtype), new_state


def conv_init_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Conv taps (W, C): the dense init with fan-in W."""
    return dense_init_(t, gen, fan_in=t.shape[0])


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_lookup(cfg, p: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    # gather then cast (or scale): elementwise, so equal to the
    # reference's cast-then-gather without converting the whole table
    return quant.gather_rows(p["tok"], tokens, cfg.compute_dtype)


def head_logits(cfg, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Final-norm output (B, S, d) -> logits (B, S, V); tied heads
    contract the embedding table, softcap when configured."""
    cd = cfg.compute_dtype
    x = x.to(cd)
    if cfg.tie_embeddings and not cfg.is_encoder:
        # the tied head contracts the table's scaled axis: a per-vocab
        # scale cannot ride a (d, V) product, so a QuantLeaf dequantizes
        logits = x @ quant.dequant(params["embed"]["tok"], cd).t()
    else:
        logits = quant.einsum(x, params["final"]["head"]["w"], cd)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
