"""Mamba-2 (SSD -- state-space duality) block of the port, after
``repro.models.ssm``.

A single input projection produces (z, x, B, C, dt); (x, B, C) pass
through a causal depthwise conv + SiLU; the SSD recurrence runs per head
with scalar decay A (``ops.ssd_scan``, the hand-written kernel on the
card); the output goes through a gated RMSNorm and the output projection.
ngroups = 1 (B and C shared across heads), matching the 780m config.

Decode keeps two states per layer: the conv ring (B, W-1, d_conv) and the
SSD state (B, nh, dp, N) f32 -- O(1) in sequence length.  With
``return_state`` the block runs the same kernel from the carried state and
returns the final one, where the reference runs its sequential ``ref.ssd``:
both compute the recurrence's final state.

Int8-resident (``compute_quant``) params keep ``in_proj`` and ``out_proj``
as ``QuantLeaf``s; each use dequantizes the whole leaf to the compute
dtype (``quant.dequant``: ``weight_transform`` on the card), where the
reference calls ``QuantLeaf.astype(cd)`` -- the same values, bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import quant
from repro_torch.kernels import ops
from repro_torch.models import layers

PyTree = Any


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, state)"""
    d_inner = cfg.ssm_expand * cfg.d_model
    if cfg.ssm_heads:
        nh = cfg.ssm_heads
        dp = d_inner // nh
    else:
        dp = cfg.ssm_head_dim or 64
        nh = d_inner // dp
    return d_inner, nh, dp, cfg.ssm_state


def ssd_shapes(cfg) -> Dict[str, Any]:
    d = cfg.d_model
    d_inner, nh, dp, N = dims(cfg)
    return {"in_proj": (d, 2 * d_inner + 2 * N + nh),    # z, x, B, C, dt
            "conv": (cfg.conv_width, d_inner + 2 * N),
            "a_log": (nh,), "d_skip": (nh,), "dt_bias": (nh,),
            "ssd_norm": {"scale": (d_inner,)},
            "out_proj": (d_inner, d)}


def ssd_init_(cfg, p: PyTree, gen: torch.Generator):
    """The reference's init: dense projections and conv taps; A = -exp(0),
    D = 1, dt bias 0 and norm scale 0."""
    layers.dense_init_(p["in_proj"], gen)
    layers.conv_init_(p["conv"], gen)
    p["a_log"].zero_()
    p["d_skip"].fill_(1.0)
    p["dt_bias"].zero_()
    p["ssd_norm"]["scale"].zero_()
    layers.dense_init_(p["out_proj"], gen, fan_in=p["out_proj"].shape[0])


def _in_proj(cfg, p: PyTree, x: torch.Tensor):
    """Projection, causal conv + SiLU and the dt / A activations shared
    by the sequence and the decode paths."""
    d_inner, nh, dp, N = dims(cfg)
    cd = cfg.compute_dtype
    zxbcdt = x.to(cd) @ quant.dequant(p["in_proj"], cd)
    z, xs, Bm, Cm, dt = torch.split(zxbcdt, [d_inner, d_inner, N, N, nh],
                                    dim=-1)
    return z, torch.cat([xs, Bm, Cm], dim=-1), dt


def _activate(cfg, p: PyTree, conv_out: torch.Tensor, dt: torch.Tensor):
    d_inner, nh, dp, N = dims(cfg)
    cd = cfg.compute_dtype
    conv_out = F.silu(conv_out.float()).to(cd)
    xs = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + N].float()
    Cm = conv_out[..., d_inner + N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])   # (B, S, nh)
    A = -torch.exp(p["a_log"])                                  # (nh,)
    return xs, Bm, Cm, dt, A


def _out(cfg, p: PyTree, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm (mamba-2: norm(y * silu(z))) and the out projection."""
    cd = cfg.compute_dtype
    y = y * F.silu(z.float()).to(cd)
    y = layers.rmsnorm(y, p["ssd_norm"]["scale"])
    return y @ quant.dequant(p["out_proj"], cd)


def ssd_block(cfg, p: PyTree, x: torch.Tensor,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None,
              *, return_state: bool = False):
    """x: (B, S, d) -> y (B, S, d) [, (conv_state, ssm_state)]."""
    Bsz, S, _ = x.shape
    d_inner, nh, dp, N = dims(cfg)
    cd = cfg.compute_dtype
    z, conv_in, dt = _in_proj(cfg, p, x)
    conv_out, new_conv_state = layers.causal_conv1d(conv_in, p["conv"],
                                                    conv_state)
    xs, Bm, Cm, dt, A = _activate(cfg, p, conv_out, dt)
    x_t = xs.reshape(Bsz, S, nh, dp).transpose(1, 2)          # (B, nh, S, dp)
    dt_t = dt.transpose(1, 2)                                 # (B, nh, S)
    out = ops.ssd_scan(x_t, dt_t, A, Bm, Cm, bc=min(cfg.ssm_chunk, S),
                       h0=ssm_state, return_state=return_state)
    y_t, hS = out if return_state else (out, None)
    y = y_t.transpose(1, 2) + \
        x_t.transpose(1, 2) * p["d_skip"][None, None, :, None]
    y = _out(cfg, p, y.reshape(Bsz, S, d_inner).to(cd), z)
    if return_state:
        return y, (new_conv_state, hS)
    return y


def ssd_decode(cfg, p: PyTree, x: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor):
    """Single-token step.  x: (B, 1, d); conv_state (B, W-1, ch);
    ssm_state (B, nh, dp, N).  Returns (y (B,1,d), conv_state, ssm_state)
    (new tensors; the caller writes them into its cache)."""
    Bsz = x.shape[0]
    d_inner, nh, dp, N = dims(cfg)
    cd = cfg.compute_dtype
    z, conv_in, dt = _in_proj(cfg, p, x)
    conv_out, conv_state = layers.causal_conv1d(conv_in, p["conv"],
                                                conv_state)
    xs, Bm, Cm, dt, A = _activate(cfg, p, conv_out, dt)
    xh = xs[:, 0].reshape(Bsz, nh, dp)
    ssm_state, y = ops.ssd_step(ssm_state, xh, dt[:, 0], A, Bm[:, 0],
                                Cm[:, 0])
    y = y + xh * p["d_skip"][None, :, None]
    y = _out(cfg, p, y.reshape(Bsz, 1, d_inner).to(cd), z)
    return y, conv_state, ssm_state


def init_states(cfg, batch: int, device) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Zeroed decode states for one SSD layer."""
    d_inner, nh, dp, N = dims(cfg)
    conv = torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * N),
                       dtype=cfg.compute_dtype, device=device)
    ssm = torch.zeros((batch, nh, dp, N), dtype=torch.float32, device=device)
    return conv, ssm
