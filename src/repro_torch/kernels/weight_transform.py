"""weight_transform: int8 dequant or float cast of one (n, m) weight
extent — the compute half of the pipeline's weight application (A).

Kernel: ``csrc/weight_transform.cu`` (see its note on what bounds it).
On a CUDA tensor :func:`weight_transform` launches that kernel or raises;
on a CPU tensor it computes :func:`plain`, the same function in PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/weight_transform.cu"
REPLACES = "src/repro/kernels/weight_transform.py:33"
launches = cuda_lib.LaunchCounter()

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}


def plain(w: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
          out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in PyTorch: ``(w.float() * scale).to(dt)``
    for int8 with per-column scales, else ``w.to(dt)``."""
    return ref.weight_transform(w, scale, out_dtype)


def weight_transform(w: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     *, out_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """w: (n, m) int8 with scale (m,) f32, or f32 with scale None.
    Returns (n, m) in ``out_dtype`` (float32 or bfloat16)."""
    if w.device.type == "cpu":
        if scale is not None and scale.device.type != "cpu":
            raise ValueError("weight_transform: w on the CPU, scale on "
                             f"{scale.device}")
        return plain(w, scale, out_dtype=out_dtype)
    if w.device.type != "cuda":
        raise ValueError(f"weight_transform: unsupported device {w.device}")
    if w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"weight_transform: w must be a contiguous (n, m) "
                         f"tensor, got shape {tuple(w.shape)} strides "
                         f"{w.stride()}")
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"weight_transform: out_dtype {out_dtype} not "
                         f"supported by the kernel (float32, bfloat16)")
    n, m = w.shape
    out = torch.empty((n, m), dtype=out_dtype, device=w.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(w.device):
        stream = cuda_lib.stream_ptr(w.device)
        if scale is not None:
            if w.dtype != torch.int8:
                raise ValueError(f"weight_transform: dequant takes int8, "
                                 f"got {w.dtype}")
            if scale.dtype != torch.float32 or tuple(scale.shape) != (m,) \
                    or not scale.is_contiguous() or scale.device != w.device:
                raise ValueError(
                    f"weight_transform: scale must be contiguous float32 "
                    f"({m},) on {w.device}, got {scale.dtype} "
                    f"{tuple(scale.shape)} on {scale.device}")
            rc = lib.repro_wt_dequant(w.data_ptr(), scale.data_ptr(),
                                      out.data_ptr(), n * m, m,
                                      _OUT_KIND[out_dtype], stream)
        else:
            if w.dtype != torch.float32:
                raise ValueError(f"weight_transform: cast takes float32, "
                                 f"got {w.dtype}")
            rc = lib.repro_wt_cast(w.data_ptr(), out.data_ptr(), n * m,
                                   _OUT_KIND[out_dtype], stream)
    cuda_lib.check(rc, "weight_transform")
    launches.add()
    return out
