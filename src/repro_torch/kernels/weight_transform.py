"""weight_transform: int8 dequant or float cast of one (n, m) weight
extent — the compute half of the pipeline's weight application (A).

Kernel: ``csrc/weight_transform.cu`` (see its note on what bounds it).
Its launch is chosen here, by :func:`plan`: a dequant thread takes V
columns of a row, one 16-byte store (V = 4 for f32, 8 for bf16; 4 where
m % 8 != 0; the scalar path where m % 4 != 0 or a pointer is not aligned
to the vector width), holds their V scales in registers and walks about
four rows' chunks of the extent grid-stride; the cast takes one tile of
float4 units a block.
On a CUDA tensor :func:`weight_transform` launches that kernel or raises;
on a CPU tensor it computes :func:`plain`, the same function in PyTorch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/weight_transform.cu"
REPLACES = "src/repro/kernels/weight_transform.py:33"
launches = cuda_lib.LaunchCounter()

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1}

THREADS = 256          # threads a block (the kernels' launch bound)
STEPS = 4              # the dequant's chunks a thread (the cast: one tile)
UNROLL = 4             # the cast's float4 units a thread a tile (as in C)
# the widest columns a thread takes a row, by output type: one 16-byte
# store (four f32, eight bf16), so a warp's store is one contiguous run
VEC_MAX = {torch.float32: 4, torch.bfloat16: 8}


class Plan(NamedTuple):
    """One launch of the kernel: ``path`` "v8", "v4" or "scalar"
    (dequant: ``vec`` columns a thread; cast: "v4" float4 units or
    "scalar"), ``grid`` blocks of ``threads`` in ``blockIdx.x`` only."""
    path: str
    vec: int
    threads: int
    grid: int


def walk_grid(n: int, chunks: int, steps: int) -> int:
    """A dequant grid that gives each thread about ``steps`` of the
    n * ``chunks`` chunks: one pass, or a multiple of a row's chunks in
    threads, so each thread keeps one column chunk (and its scales)
    throughout."""
    one_pass = -(-n * chunks // THREADS)
    unit = chunks // math.gcd(chunks, THREADS)
    return min(one_pass, -(-one_pass // (steps * unit)) * unit)


def plan(n: int, m: int, out_dtype: torch.dtype, w_ptr: int,
         scale_ptr: Optional[int], out_ptr: int) -> Plan:
    """The launch for an (n, m) extent (``scale_ptr`` None: the cast).
    A vector path needs its pointers aligned to its loads and stores:
    ``w`` to V bytes (16 for the cast), ``scale`` and ``out`` to 16.  The
    dequant's grid gives each thread about ``STEPS`` chunks to walk; the
    cast's, one tile a block."""
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"weight_transform: out_dtype {out_dtype} not "
                         f"supported by the kernel (float32, bfloat16)")
    if scale_ptr is None:
        vec = 4 if w_ptr % 16 == 0 and out_ptr % 16 == 0 else 1
        tiles = -(-max(1, n * m // vec) // (UNROLL * THREADS))
        return Plan("v4" if vec == 4 else "scalar", vec, THREADS, tiles)
    aligned = scale_ptr % 16 == 0 and out_ptr % 16 == 0
    vec = next((v for v in (8, 4) if v <= VEC_MAX[out_dtype] and
                m % v == 0 and aligned and w_ptr % v == 0), 1)
    return Plan("scalar" if vec == 1 else f"v{vec}", vec, THREADS,
                walk_grid(n, m // vec, STEPS))


def launch(p: Plan, w: torch.Tensor, scale: Optional[torch.Tensor],
           out: torch.Tensor, lib=None) -> int:
    """Launch plan ``p`` on the current stream; returns the C entry's
    code (0 when the launch went)."""
    lib = lib or cuda_lib.library()
    n, m = w.shape
    stream = cuda_lib.stream_ptr(w.device)
    kind = _OUT_KIND[out.dtype]
    if scale is not None:
        return lib.repro_wt_dequant(w.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), n, m, p.vec, p.threads,
                                    p.grid, kind, stream)
    return lib.repro_wt_cast(w.data_ptr(), out.data_ptr(), n * m, p.vec,
                             p.threads, p.grid, kind, stream)


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
    elif w.dtype != torch.float32:
        raise ValueError(f"weight_transform: cast takes float32, "
                         f"got {w.dtype}")
    out = torch.empty((n, m), dtype=out_dtype, device=w.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(w.device):
        p = plan(n, m, out_dtype, w.data_ptr(),
                 None if scale is None else scale.data_ptr(),
                 out.data_ptr())
        rc = launch(p, w, scale, out)
    cuda_lib.check(rc, "weight_transform")
    launches.add()
    return out
