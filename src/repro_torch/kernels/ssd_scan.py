"""ssd_scan: the Mamba-2 SSD scan, x (b, nh, S, dp) with step sizes dt
(b, nh, S) > 0, decay rates A (nh,) < 0 and shared projections B, C
(b, S, N), from an optional initial state h0 (b, nh, dp, N), returning y
(b, nh, S, dp) in x's dtype and, on request, the final state (f32).

Kernel: ``csrc/ssd_scan.cu`` (see its note on what bounds it).  On CUDA
tensors :func:`ssd_scan` launches that kernel or raises; on CPU tensors
it computes :func:`plain`, the sequential definition
(:func:`repro_torch.kernels.ref.ssd`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:73"
launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 128                     # state width the bf16 kernel takes
# (chunk, cols) instances of the bf16 kernel; f32 runs (64, 16)
BF16_PLANS = ((64, 16), (64, 32), (64, 64), (32, 16), (128, 16))
F32_PLAN = (64, 16)


class Plan(NamedTuple):
    """Launch of the kernel: chunks of ``chunk`` steps from the call's first
    step, ``cols`` columns of dp a block."""
    chunk: int
    cols: int


def plan(dp: int, N: int, dtype: torch.dtype) -> Plan:
    """The chunk length and dp columns a block, from the head geometry and
    dtype alone (never B or S), so that a row's chunks, and so its bits,
    are the same in any batch and under trailing padding.

    bf16: 64-step chunks (four warps of 16 rows), 16 columns a block: 192
    blocks at mamba2-780m's 48 heads of dp 64.  On an NVIDIA H100 80GB
    HBM3 at 700.00 W, x (1, 48, 128, 64) bf16, N 128, device ms by
    ``ab.py --sweep`` (chunk x columns): 64x16 0.01919, 64x32 0.02276,
    64x64 0.03651, 32x16 0.03165, 128x16 0.02552.  f32 takes the one
    instance of its design."""
    del dp, N
    return Plan(*(BF16_PLANS[0] if dtype == torch.bfloat16 else F32_PLAN))


def plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor, *,
          h0: Optional[torch.Tensor] = None, return_state: bool = False):
    return ref.ssd(x, dt, A, B, C, h0=h0, return_state=return_state)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Shapes as in :func:`repro_torch.kernels.ref.ssd`.  Returns y, or
    (y, h_S) with ``return_state``."""
    if x.device.type == "cpu":
        return plain(x, dt, A, B, C, h0=h0, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE:
        raise ValueError(f"ssd_scan: x must be (b, nh, S, dp) float32 or "
                         f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    b, nh, S, dp = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": (dt, (b, nh, S)), "A": (A, (nh,)), "B": (B, (b, S, N)),
            "C": (C, (b, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (b, nh, dp, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous float32 "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not x.is_contiguous():
        raise ValueError(f"ssd_scan: x must be contiguous, got strides "
                         f"{x.stride()}")
    if x.dtype == torch.bfloat16 and N > MAX_N:
        raise ValueError(f"ssd_scan: state width {N} above the bf16 "
                         f"kernel's {MAX_N}")
    y = torch.empty_like(x)
    hS = (torch.empty((b, nh, dp, N), dtype=torch.float32, device=x.device)
          if return_state else None)
    if x.numel() == 0:                  # nothing to scan: the state is h0
        if hS is not None:
            hS.copy_(h0 if h0 is not None else torch.zeros_like(hS))
        return (y, hS) if return_state else y
    p = plan(dp, N, x.dtype)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), None if hS is None else hS.data_ptr(), b, nh, S,
            dp, N, _DTYPE[x.dtype], p.chunk, p.cols,
            cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ssd_scan")
    launches.add()
    return (y, hS) if return_state else y
