"""Griffin / RecurrentGemma recurrent block of the port (RG-LRU), after
``repro.models.griffin``.

    px = x W_x        (value branch, causal conv width-4, then RG-LRU)
    pg = gelu(x W_g)  (gate branch)
    r  = sigmoid(px * w_a + b_a)       (diagonal recurrence gate)
    i  = sigmoid(px * w_i + b_i)       (diagonal input gate)
    a  = exp(-c * softplus(lam) * r)   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * px_t)
    y  = (h * pg) W_y

The recurrence runs in ``ops.rglru_scan`` (the hand-written kernel on the
card), from the carried state and returning the final one under
``return_state`` (the reference runs its sequential ``ref.rglru`` there:
both compute the same state).  The hybrid's attention layers are the
dense ``attn`` blocks with the config's ``sliding_window`` (0 for
recurrentgemma-2b: full attention), as in the reference's code.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import quant
from repro_torch.kernels import ops
from repro_torch.models import layers

PyTree = Any
RGLRU_C = 8.0


def _width(cfg) -> int:
    return cfg.rglru_width or cfg.d_model


def rglru_shapes(cfg) -> Dict[str, Any]:
    d, w = cfg.d_model, _width(cfg)
    return {"wx": (d, w), "wgate": (d, w), "conv": (cfg.conv_width, w),
            "wa": (w,), "ba": (w,), "wi": (w,), "bi": (w,), "lam": (w,),
            "wy": (w, d)}


def rglru_init_(cfg, p: PyTree, gen: torch.Generator):
    """The reference's init: dense projections and conv taps, zero gates,
    ``lam`` at 0.65 (a ~ 0.9..0.999 at r = 0.5)."""
    layers.dense_init_(p["wx"], gen)
    layers.dense_init_(p["wgate"], gen)
    layers.conv_init_(p["conv"], gen)
    for name in ("wa", "ba", "wi", "bi"):
        p[name].zero_()
    p["lam"].fill_(0.65)
    layers.dense_init_(p["wy"], gen, fan_in=p["wy"].shape[0])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus as the reference computes it (``jax.nn.softplus``:
    ``logaddexp(x, 0)``, one rounding per op in x's dtype), so that a
    ``lam`` cast to bf16 at A rounds as it does there; ``F.softplus``
    rounds once."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gates(p: PyTree, px: torch.Tensor):
    pxf = px.float()
    r = torch.sigmoid(pxf * p["wa"] + p["ba"])
    i = torch.sigmoid(pxf * p["wi"] + p["bi"])
    log_a = -RGLRU_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # 1 - a^2 computed stably via expm1
    b_scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, b_scale * (i * pxf)


def _branches(cfg, p: PyTree, x: torch.Tensor):
    cd = cfg.compute_dtype
    px = quant.einsum(x, p["wx"], cd)
    pg = layers.gelu(quant.einsum(x, p["wgate"], cd).float()).to(cd)
    return px, pg


def rglru_block(cfg, p: PyTree, x: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None,
                h_state: Optional[torch.Tensor] = None,
                *, return_state: bool = False):
    """x: (B, S, d) -> y (B, S, d) [, (conv_state, h_state)]."""
    cd = cfg.compute_dtype
    px, pg = _branches(cfg, p, x)
    px, new_conv_state = layers.causal_conv1d(px, p["conv"], conv_state)
    a, b = _gates(p, px)
    out = ops.rglru_scan(a, b, h0=h_state, return_state=return_state)
    h, hS = out if return_state else (out, None)
    y = quant.einsum(h.to(cd) * pg, p["wy"], cd)
    if return_state:
        return y, (new_conv_state, hS)
    return y


def rglru_decode(cfg, p: PyTree, x: torch.Tensor, conv_state: torch.Tensor,
                 h_state: torch.Tensor):
    """Single-token step.  x: (B, 1, d); h_state (B, W).  Returns (y,
    conv_state, h_state) (new tensors; the caller writes them into its
    cache)."""
    cd = cfg.compute_dtype
    px, pg = _branches(cfg, p, x)
    px, conv_state = layers.causal_conv1d(px, p["conv"], conv_state)
    a, b = _gates(p, px)                                  # (B, 1, W)
    h_state = ops.rglru_step(h_state, a[:, 0], b[:, 0])
    y = quant.einsum(h_state[:, None].to(cd) * pg, p["wy"], cd)
    return y, conv_state, h_state


def init_states(cfg, batch: int, device) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Zeroed decode states for one RG-LRU layer."""
    w = _width(cfg)
    conv = torch.zeros((batch, cfg.conv_width - 1, w),
                       dtype=cfg.compute_dtype, device=device)
    h = torch.zeros((batch, w), dtype=torch.float32, device=device)
    return conv, h
