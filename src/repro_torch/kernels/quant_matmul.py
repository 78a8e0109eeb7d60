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

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/quant_matmul.cu"
REPLACES = "src/repro/kernels/quant_matmul.py:48"
launches = cuda_lib.LaunchCounter()

_KIND = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 4 * 65535            # grid.y of 4-row tiles (the f32 design)
SMS = 132                       # streaming multiprocessors of an H100
TILE_N = 128                    # weight columns a block (bf16 design)
KSTEP = 16                      # k per tensor-core step


class Plan(NamedTuple):
    """How the bf16 kernel sums over K: ``n_slices`` slices of
    ``slice_k`` (a multiple of 16; the last may be shorter), each summed
    from zero on the tensor cores, the slice sums added in slice order."""
    slice_k: int
    n_slices: int


def plan(k: int, n: int) -> Plan:
    """The split over K, from (K, N) alone, so that every row's result is
    the same at any M.  One slice where the weight's column tiles already
    fill the card; else slices short enough that a decode product (one row
    tile) spreads over at least :data:`SMS` blocks, down to one step."""
    tiles = -(-n // TILE_N)
    want = -(-SMS // tiles)
    if want <= 1:
        slice_k = -(-k // KSTEP) * KSTEP
    else:
        slice_k = max(KSTEP, (k // want) // KSTEP * KSTEP)
    return Plan(slice_k, -(-k // slice_k))


class Launch(NamedTuple):
    """How one call runs under its plan: ``bm`` rows of x a block, and
    ``groups`` k groups (1: a block adds all the slices; ``n_slices``: a
    block per slice, the partials added by a second pass over an f32
    scratch).  It changes no addition and no order of additions."""
    bm: int
    groups: int


def launch_shape(p: Plan, m: int, n: int) -> Launch:
    """The launch of an m-row product under plan p: 8-row tiles up to 16
    rows, else 32; the slices run in blocks of their own when the
    (column, row) tiles alone would leave SMs idle."""
    bm = 8 if m <= 16 else 32
    tiles = -(-n // TILE_N) * -(-m // bm)
    return Launch(bm, p.n_slices if tiles < SMS else 1)


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
    if x.dtype == torch.float32 and m > MAX_ROWS:
        raise ValueError(f"quant_matmul: {m} rows exceed the kernel's "
                         f"{MAX_ROWS}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m and n:
        if k == 0:
            out.zero_()
        else:
            p = plan(k, n)
            ls = launch_shape(p, m, n)
            part = None
            if x.dtype == torch.bfloat16 and ls.groups > 1:
                part = torch.empty((ls.groups, m, n), dtype=torch.float32,
                                   device=x.device)
            lib = cuda_lib.library()
            with torch.cuda.device(x.device):
                rc = lib.repro_quant_matmul(
                    x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), 0 if part is None else part.data_ptr(),
                    m, k, n, _KIND[x.dtype], _KIND[out_dtype], p.slice_k,
                    p.n_slices, *ls, cuda_lib.stream_ptr(x.device))
            cuda_lib.check(rc, "quant_matmul")
            launches.add()
    return out.reshape(lead + (n,))
