"""The benchmark's own copy of the store's per-column int8 formula and
of the lower precision its control computes in.

int8: over a leaf's last axis, scale = amax / 127 of the column (1 for a
column of zeros), values rounded half to even and clipped to +-127;
dequantized as values times scale in f32.
"""
from __future__ import annotations

import torch

BLOCK_BYTES = 1 << 30


def int8_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """``w`` (f32, any shape of two or more axes) quantized per column of
    its last axis and dequantized again, in f32."""
    w2 = w.reshape(-1, w.shape[-1])
    rows = max(1, BLOCK_BYTES // (4 * w2.shape[1]))
    amax = None
    for i in range(0, w2.shape[0], rows):
        a = w2[i:i + rows].abs().amax(dim=0)
        amax = a if amax is None else torch.maximum(amax, a)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    out = torch.empty_like(w2)
    for i in range(0, w2.shape[0], rows):
        q = (w2[i:i + rows] / scale).round_().clamp_(-127, 127)
        out[i:i + rows] = q * scale
    return out.reshape(w.shape)


FP8_MAX = 448.0      # largest finite float8_e4m3fn


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one f32 scale per slice along
    ``dim`` (amax / 448), back in f32: the control's operands."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s
