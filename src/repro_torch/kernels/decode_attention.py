"""decode_attention: one-token attention of q (B, H, dh) over a slotted
kv-major cache (B, K, S_max, dh), each row at its own ``pos``, with the
ring-buffer rule when a window is set; and decode_attention_paged, the
same over page pools (P, K, pt, dh) through a page table (B, NP).

Kernels: ``csrc/decode_attention.cu`` (see its note on what bounds them).
Each call is two launches: the cache split into :func:`plan`'s
``split_len`` positions a block, each split's partial softmax statistics
written to an f32 scratch, then a merge of a row's splits in split order.
On CUDA tensors :func:`decode_attention` and
:func:`decode_attention_paged` launch their kernels or raise; on CPU
tensors they compute :func:`plain` / :func:`plain_paged` (the oracles in
:mod:`repro_torch.kernels.ref`); on meta tensors they check the call and
return the output's shape with the splits' scratch allocated, launching
nothing.  :func:`cost` and :func:`cost_paged` count a call's work.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, padded_dim

SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:98"
REPLACES_PAGED = "src/repro/kernels/decode_attention.py:148"
launches = cuda_lib.LaunchCounter()
paged_launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 16                      # keys per tensor-core step
MAX_SPLIT = 256                 # split lengths the kernels take


def max_rep(dh: int) -> int:
    """Query heads per kv head the kernel takes at head dim ``dh`` (16, the
    tensor-core tile's rows, up to a padded dh of 128; 12 at 256, where the
    f32 body's shared memory runs out).  Every assigned config is within:
    rep 10 at dh 256 (recurrentgemma-2b), 8 at dh 128 (yi-9b,
    internvl2-76b), 4 at dh 120 (h2o-danube-3-4b)."""
    return 16 if padded_dim(dh) <= 128 else 12


def plan(K: int, rep: int, dh: int) -> int:
    """``split_len``: the cache positions one block covers, a multiple of
    :data:`CHUNK`, from the model's head geometry alone (never the batch,
    the cache length, ``pos`` or the page size), so that a row's splits,
    and every addition in them and in their merge, are the same whatever
    the batch and cache it is decoded in.

    Chosen by ``ab.py --sweep`` on an NVIDIA H100 80GB HBM3 at 700.00 W
    (device ms at split 16 / 32 / 64 / 128 / 256).  smollm-360m's heads
    (K 5, rep 3, dh 64) at a 160-row cache: 0.0067 / 0.0055 / 0.0050 /
    0.0052 / 0.0055; paged, 4 rows: 0.0076 / 0.0057 / 0.0054 / 0.0057 /
    0.0064; 4 rows over 2048: 0.0347 / 0.0204 / 0.0140 / 0.0102 /
    0.0090.  recurrentgemma-2b's (K 1, rep 10, dh 256) at 160 rows:
    0.0120 / 0.0096 / 0.0083 / 0.0104 / 0.0127.  So 128 up to dh 128
    (within 0.0003 ms of the best at 160 rows, 0.0038 faster than 64 at
    2048 rows; 256 is faster there but slower at 160) and 64 at dh 256.

    The split depends on dh through the padded instance alone
    (:func:`padded_dim`): a chunk of a dh-80 or dh-120 row costs what one
    of dh 128 does, since the padding columns are multiplied too, and one
    of dh 20 what one of dh 32 does.  dh 65-128 take dh 64's split, 128:
    yi-9b's heads (K 4, rep 8, dh 128) at 160 rows 0.0081 / 0.0062 /
    0.0053 / 0.0058 / 0.0061, 4 rows over 2048 0.0390 / 0.0234 / 0.0153
    / 0.0111 / 0.0093; h2o-danube-3-4b's (K 8, rep 4, dh 120) at 160
    rows 0.0083 / 0.0065 / 0.0059 / 0.0068 / 0.0080 -- as at dh 64, 128
    is within 0.001 ms of the best at 160 rows and 28% faster than 64 at
    2048.  dh 1-32 take it too: their chunks are shorter still, so a long
    split loses nothing to the work per block."""
    del K, rep
    return 64 if padded_dim(dh) >= 256 else 128


def _launch(fn, what: str, q, pools, extra, s_ext: int, K: int, dh: int,
            window: int, counter):
    """Size the splits from shapes alone, allocate their scratch, launch
    the two kernels on q's stream, count the call once."""
    B, H = q.shape[0], q.shape[1]
    rep = H // K
    split_len = plan(K, rep, dh)
    n_split = -(-s_ext // split_len)
    out = torch.empty_like(q)
    part = torch.empty(B * K * n_split * rep * (padded_dim(dh) + 2),
                       dtype=torch.float32, device=q.device)
    if q.device.type == "meta":             # shapes only: nothing launches
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), *(t.data_ptr() for t in pools), out.data_ptr(),
            part.data_ptr(), B, H, K, *extra, dh, _DTYPE[q.dtype],
            int(max(window, 0)), 1.0 / math.sqrt(dh), split_len,
            cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, what)
    counter.add()
    return out


def plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window)


def plain_paged(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, tables: torch.Tensor,
                pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    return ref.decode_attention_paged(q, k_pages, v_pages, tables, pos,
                                      window=window)


def _cost(q: torch.Tensor, K: int, keys: int, extra_bytes: int) -> tuple:
    """4 dh a (query head, key read) (the two products); q read and the
    output written once, each row's ``keys`` cached K and V rows read
    once, plus ``extra_bytes`` (pos, the page table)."""
    B, H, dh = q.shape
    return (4 * H * dh * keys * B,
            q.element_size() * (2 * q.numel() + 2 * B * keys * K * dh)
            + extra_bytes)


def cost(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         pos: torch.Tensor, *, window: int = 0) -> tuple:
    """(flops, bytes) of one call, from the shapes: each row reads all
    ``S_max`` cache positions (a row at the end of its cache), or the
    window's."""
    S_max = k_cache.shape[2]
    keys = min(S_max, window) if window > 0 else S_max
    return _cost(q, k_cache.shape[1], keys, pos.element_size() * pos.numel())


def cost_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               tables: torch.Tensor, pos: torch.Tensor, *, window: int = 0
               ) -> tuple:
    """(flops, bytes) of one paged call, as :func:`cost`, over the table's
    ``NP * pt`` positions a row; the tables read once too."""
    span = tables.shape[1] * k_pages.shape[2]
    keys = min(span, window) if window > 0 else span
    return _cost(q, k_pages.shape[1], keys,
                 4 * (tables.numel() + pos.numel()))


def _check_heads(what: str, q: torch.Tensor, K: int, dh: int):
    H = q.shape[1]
    if K == 0 or H % K or q.shape[2] != dh:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match {K} "
                         f"kv heads of dim {dh}")
    if not 1 <= dh <= HEAD_DIMS[-1] or H // K > max_rep(dh):
        raise ValueError(f"{what}: head dim {dh} (1 to {HEAD_DIMS[-1]}) or "
                         f"rep {H // K} (max {max_rep(dh)}) not supported by "
                         f"the kernel")


@cuda_lib.accounted("decode_attention", cost)
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); caches: (B, K, S_max, dh); pos: (B,) int32.
    Returns (B, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return cuda_lib.kernel_layout(plain(q, k_cache, v_cache, pos,
                                            window=window))
    if q.device.type not in ("cuda", "meta"):
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
    if B == 0:
        return torch.empty_like(q)
    return _launch("repro_decode_attention", "decode_attention", q,
                   (k_cache, v_cache, pos), (S_max,), S_max, K, dh, window,
                   launches)


@cuda_lib.accounted("decode_attention_paged", cost_paged)
def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (B, H, dh); pools: (P, K, pt, dh); tables: (B, NP) int32 page
    ids in [0, P); pos: (B,) int32.  Returns (B, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return cuda_lib.kernel_layout(plain_paged(
            q, k_pages, v_pages, tables, pos, window=window))
    if q.device.type not in ("cuda", "meta"):
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
    if B == 0:
        return torch.empty_like(q)
    NP = tables.shape[1]
    return _launch("repro_decode_attention_paged", "decode_attention_paged",
                   q, (k_pages, v_pages, tables, pos), (NP, pt), NP * pt, K,
                   dh, window, paged_launches)
