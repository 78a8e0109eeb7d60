"""flash_attention: prefill attention over the model layout, q
(B, S, H, dh) against k/v (B, T, K, dh), GQA by kv head ``h // rep``,
queries at the last S of T positions, causal and/or sliding window.

Kernel: ``csrc/flash_attention.cu`` (see its note on what bounds it).
On CUDA tensors :func:`flash_attention` launches that kernel or raises;
on CPU tensors it computes :func:`plain`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:93"
launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)          # the kernels' instances (padded dh)
KEY_TILE = {32: 64, 64: 64, 128: 64, 256: 32}   # keys per K/V tile (bf16)
WARPS = 4                               # warps (16 rows each) a block


def padded_dim(dh: int) -> int:
    """The instance a head dim runs in: the next of :data:`HEAD_DIMS` at or
    above ``dh``.  The kernels read rows of the true ``dh`` and zero-fill
    the rest on chip, so any dh from 1 to 256 is taken, as the TPU kernels
    take the whole dh as one block."""
    for dp in HEAD_DIMS:
        if dh <= dp:
            return dp
    raise ValueError(f"head dim {dh} above the kernels' largest, "
                     f"{HEAD_DIMS[-1]}")


class Plan(NamedTuple):
    """Launch of the bf16 kernel: ``warps`` warps of 16 (position, head)
    rows a block, K/V tiles of ``key_tile`` keys at absolute positions,
    ``blocks`` blocks in all."""
    warps: int
    key_tile: int
    blocks: int


def plan(B: int, S: int, H: int, K: int, dh: int) -> Plan:
    """Blocks of :data:`WARPS` warps over the (position, head) rows of each
    kv head, position-major, so the rep query heads of a kv head share
    each K/V tile.  Four warps beat one or two on the H100 at every timed
    S, though at S = 128 they leave SMs idle (``ab.py --sweep``).  The key
    tile is fixed by the padded dh, so the plan changes no row's
    result."""
    tiles = -(-S * (H // K) // (16 * WARPS))
    return Plan(WARPS, KEY_TILE[padded_dim(dh)], tiles * K * B)


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel's function in PyTorch, materialising the scores in f32.
    Masks use absolute positions (query i sits at T - S + i); a row with
    no key left after masking gives 0."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.float().transpose(1, 2)                             # B,H,S,dh
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = (qf @ kf.transpose(-1, -2)) / math.sqrt(dh)            # B,H,S,T
    qpos = (T - S) + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    if causal:
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
    elif window > 0:
        mask = (kpos - qpos).abs() < window
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ vf) / torch.where(l == 0, torch.ones_like(l), l)
    return o.transpose(1, 2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, dh); k, v: (B, T, K, dh).  Returns (B, S, H, dh)
    contiguous, in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,S,H,dh), k/v (B,T,K,dh) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or K == 0 or H % K:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)} and "
                         f"{tuple(k.shape)} do not match")
    if not 1 <= dh <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head dim {dh} not supported by "
                         f"the kernel (1 to {HEAD_DIMS[-1]})")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (float32 or bfloat16, all equal)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be on {q.device} "
                             f"with a contiguous last dim, got {t.device} "
                             f"strides {t.stride()}")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    if T == 0:
        return out.zero_()
    p = plan(B, S, H, K, dh)
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, S, T, dh, _DTYPE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(max(window, 0)), 1.0 / math.sqrt(dh),
            p.warps, p.key_tile, cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "flash_attention")
    launches.add()
    return out
