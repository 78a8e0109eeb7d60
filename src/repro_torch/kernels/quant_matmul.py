"""quant_matmul: w8a16 product of x (..., k) with an int8 weight (k, n)
and its per-column f32 scale (n,), the dequantization fused into the
kernel — every weight projection and the head of an int8-resident
(``compute_quant``) model.

Kernel: ``csrc/quant_matmul.cu`` (see its note on what bounds it).
On CUDA tensors :func:`quant_matmul` launches that kernel or raises; on
CPU tensors it computes :func:`plain` (the oracle
:func:`repro_torch.kernels.ref.quant_matmul`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul.py:48"
launches = cuda_lib.LaunchCounter()

_KIND = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 4 * 65535            # grid.y of 4-row tiles


def plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in PyTorch, over the trailing axis of x."""
    lead = x.shape[:-1]
    out = ref.quant_matmul(x.reshape(-1, x.shape[-1]), w, scale, out_dtype)
    return out.reshape(lead + (w.shape[1],))


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (..., k) float32 or bfloat16; w: (k, n) int8; scale: (n,)
    float32.  Leading axes of x collapse into the rows and come back on
    the output (..., n), in ``out_dtype`` (default x's dtype)."""
    if x.device.type == "cpu":
        return plain(x, w, scale, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    if w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"quant_matmul: w must be (k, n) int8, got "
                         f"{w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} does not "
                         f"contract with w {tuple(w.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"quant_matmul: scale must be float32 ({n},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in _KIND or out_dtype not in _KIND:
        raise ValueError(f"quant_matmul: x {x.dtype} -> {out_dtype} not "
                         f"supported by the kernel (float32, bfloat16)")
    for name, t in (("w", w), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous on "
                             f"{x.device}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"quant_matmul: {m} rows exceed the kernel's "
                         f"{MAX_ROWS}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        if k == 0:
            out.zero_()
        else:
            lib = cuda_lib.library()
            with torch.cuda.device(x.device):
                rc = lib.repro_quant_matmul(
                    x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), m, k, n, _KIND[x.dtype],
                    _KIND[out_dtype], cuda_lib.stream_ptr(x.device))
            cuda_lib.check(rc, "quant_matmul")
            launches.add()
    return out.reshape(lead + (n,))
