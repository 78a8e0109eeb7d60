"""rmsnorm: RMS normalisation over the last axis, ``x / sqrt(mean(x^2) +
eps) * (1 + scale)`` in f32, rounded once into x's dtype.

Kernel: ``csrc/rmsnorm.cu`` (see its note: a row's bits do not depend on
how many rows a call holds, which the decode scheduler's bit-identity
with ``reference_generate`` needs).  On CUDA tensors :func:`rmsnorm`
launches that kernel or raises; on CPU tensors it computes :func:`plain`.

Training goes through :class:`RMSNorm`, whose backward is
:func:`rmsnorm_bwd` (the same source's ``repro_rmsnorm_bwd`` on CUDA
tensors, :func:`plain_bwd` on CPU tensors); :func:`norm` picks it only
where a gradient is wanted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/models/layers.py:44"      # XLA's, not a TPU kernel
launches = cuda_lib.LaunchCounter()
bwd_launches = cuda_lib.LaunchCounter()      # repro_rmsnorm_bwd calls

_KIND = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROWS = 16        # rows a block of the backward's first pass (rmsnorm.cu)


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


def plain_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
              eps: float = 1e-6):
    """The backward's formulas in PyTorch (not autograd), with ``w = 1 +
    scale`` and ``r = rsqrt(mean(x^2) + eps)``: ``dx = r g w - x r^3
    mean(g w x)`` in x's dtype, ``dscale = sum over rows of g x r`` in
    scale's dtype."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = gf * (1.0 + scale.float())
    dx = r * gw - xf * r.pow(3) * (gw * xf).mean(dim=-1, keepdim=True)
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6):
    """x, g: (..., d) in one dtype; scale (d,).  Returns (dx like x,
    dscale like scale)."""
    if x.device.type == "cpu":
        return plain_bwd(x, scale, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _KIND or scale.dtype not in _KIND or \
            g.dtype != x.dtype or g.shape != x.shape or \
            tuple(scale.shape) != (d,) or not 1 <= d <= 12000 or \
            scale.device != x.device or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: x and g (..., d) in one dtype, d up "
                         f"to 12000, scale (d,), float32 or bfloat16 on one "
                         f"device, got {x.dtype} {tuple(x.shape)}, {g.dtype} "
                         f"{tuple(g.shape)}, {scale.dtype} "
                         f"{tuple(scale.shape)}")
    x, g, sc = x.contiguous(), g.contiguous(), scale.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(scale)
    partial = torch.empty((-(-rows // BWD_ROWS), d), dtype=torch.float32,
                          device=x.device)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch_bwd(x, sc, g, dx, partial, dscale, rows, d, eps)
    return dx, dscale.to(scale.dtype)


def _launch_bwd(x, scale, g, dx, partial, dscale, rows: int, d: int,
                eps: float):
    """One call of the backward's two kernels on the current stream;
    raises if the library reports an error, and counts the call only when
    it launched."""
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, float(eps),
            _KIND[x.dtype], _KIND[scale.dtype],
            cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "rmsnorm_bwd")
    bwd_launches.add()


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with a gradient: the forward keeps x and the scale,
    the backward is :func:`rmsnorm_bwd` (the kernel on CUDA tensors, which
    raises where it does not take the call; :func:`plain_bwd` on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None


def norm(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """The model's entry: :class:`RMSNorm` where autograd records and an
    input wants a gradient, else :func:`rmsnorm` as it always ran."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)
