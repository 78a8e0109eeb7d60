"""decode_attention: one-token attention of q (B, H, dh) over a slotted
kv-major cache (B, K, S_max, dh), each row at its own ``pos``, with the
ring-buffer rule when a window is set; and decode_attention_paged, the
same over page pools (P, K, pt, dh) through a page table (B, NP).

Kernels: ``csrc/decode_attention.cu`` (see its note on what bounds them).
On CUDA tensors :func:`decode_attention` and
:func:`decode_attention_paged` launch their kernel or raise; on CPU
tensors they compute :func:`plain` / :func:`plain_paged` (the oracles in
:mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:98"
REPLACES_PAGED = "src/repro/kernels/decode_attention.py:148"
launches = cuda_lib.LaunchCounter()
paged_launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)


def max_rep(dh: int) -> int:
    """Query heads per kv head the kernel takes at head dim ``dh``."""
    return 16 if dh <= 128 else 12


def plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)


def plain_paged(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, tables: torch.Tensor,
                pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    return ref.decode_attention_paged(q, k_pages, v_pages, tables, pos,
                                      window=window)


def _check_heads(what: str, q: torch.Tensor, K: int, dh: int):
    H = q.shape[1]
    if K == 0 or H % K or q.shape[2] != dh:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match {K} "
                         f"kv heads of dim {dh}")
    if dh not in HEAD_DIMS or H // K > max_rep(dh):
        raise ValueError(f"{what}: head dim {dh} ({HEAD_DIMS}) or rep "
                         f"{H // K} (max {max_rep(dh)}) not supported by "
                         f"the kernel")


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
    if k_cache.shape[0] != B:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k_cache.shape)} do not match")
    _check_heads("decode_attention", q, K, k_cache.shape[3])
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


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); pools: (P, K, pt, dh); tables: (B, NP) int32 page
    ids in [0, P); pos: (B,) int32.  Returns (B, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return plain_paged(q, k_pages, v_pages, tables, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device "
                         f"{q.device}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"decode_attention_paged: q (B,H,dh), pools "
                         f"(P,K,pt,dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B = q.shape[0]
    P, K, pt, dh = k_pages.shape
    _check_heads("decode_attention_paged", q, K, dh)
    if q.dtype not in _DTYPE or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise ValueError(f"decode_attention_paged: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype} (float32 or "
                         f"bfloat16, all equal)")
    if tables.dtype != torch.int32 or tables.dim() != 2 or \
            tables.shape[0] != B or tables.shape[1] == 0:
        raise ValueError(f"decode_attention_paged: tables must be int32 "
                         f"({B}, NP), got {tables.dtype} "
                         f"{tuple(tables.shape)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention_paged: pos must be int32 ({B},),"
                         f" got {pos.dtype} {tuple(pos.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention_paged: {name} must be "
                             f"contiguous on {q.device}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_decode_attention_paged(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, q.shape[1],
            K, tables.shape[1], pt, dh, _DTYPE[q.dtype], int(max(window, 0)),
            1.0 / math.sqrt(dh), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "decode_attention_paged")
    paged_launches.add()
    return out
