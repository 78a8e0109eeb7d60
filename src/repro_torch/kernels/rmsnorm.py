"""rmsnorm: RMS normalisation over the last axis, ``x / sqrt(mean(x^2) +
eps) * (1 + scale)`` in f32, rounded once into x's dtype.

Kernel: ``csrc/rmsnorm.cu`` (see its note: a row's bits do not depend on
how many rows a call holds, which the decode scheduler's bit-identity
with ``reference_generate`` needs).  On CUDA tensors :func:`rmsnorm`
launches that kernel or raises; on CPU tensors it computes :func:`plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/models/layers.py:44"      # XLA's, not a TPU kernel
launches = cuda_lib.LaunchCounter()

_KIND = {torch.float32: 0, torch.bfloat16: 1}


def plain(x: torch.Tensor, scale: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    """The reference's rmsnorm in PyTorch, op for op."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16; scale: (d,) float32 or bfloat16.
    Returns x's shape and dtype."""
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _KIND or scale.dtype not in _KIND or \
            tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: x (..., d) and scale (d,) float32 or "
                         f"bfloat16 on one device, got {x.dtype} "
                         f"{tuple(x.shape)}, {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm(x.data_ptr(), scale.contiguous().data_ptr(),
                               y.data_ptr(), rows, d, float(eps),
                               _KIND[x.dtype], _KIND[scale.dtype],
                               cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "rmsnorm")
    launches.add()
    return y
