"""decode_attention: one-token attention of q (B, H, dh) over a slotted
kv-major cache (B, K, S_max, dh), each row at its own ``pos``, with the
ring-buffer rule when a window is set.

Kernel: ``csrc/decode_attention.cu`` (see its note on what bounds it).
On CUDA tensors :func:`decode_attention` launches that kernel or raises;
on CPU tensors it computes :func:`plain` (the oracle
:func:`repro_torch.kernels.ref.decode_attention`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:98"
launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
MAX_REP = 16


def plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); caches: (B, K, S_max, dh); pos: (B,) int32.
    Returns (B, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k_cache, v_cache, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q (B,H,dh), caches "
                         f"(B,K,S_max,dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, dh = q.shape
    K, S_max = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != dh or K == 0 or H % K:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)} do not match")
    if H // K > MAX_REP or dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: rep {H // K} (max {MAX_REP}) or "
                         f"head dim {dh} ({HEAD_DIMS}) not supported by the "
                         f"kernel")
    if q.dtype not in _DTYPE or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype} (float32 or "
                         f"bfloat16, all equal)")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: pos must be int32 ({B},), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"on {q.device}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, H, K, S_max, dh,
            _DTYPE[q.dtype], int(max(window, 0)), 1.0 / math.sqrt(dh),
            cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "decode_attention")
    launches.add()
    return out
