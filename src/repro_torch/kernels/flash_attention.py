"""flash_attention: prefill attention over the model layout, q
(B, S, H, dh) against k/v (B, T, K, dh), GQA by kv head ``h // rep``,
queries at the last S of T positions, causal and/or sliding window.

Kernel: ``csrc/flash_attention.cu`` (see its note on what bounds it).
On CUDA tensors :func:`flash_attention` launches that kernel or raises;
on CPU tensors it computes :func:`plain`; on meta tensors it checks the
call as the kernel would and returns its outputs' shapes, launching
nothing.  Asked for it, each also returns each row's log-sum-exp, which
the backward reads.  :func:`cost` counts the call's work from its shapes.

Training goes through :class:`FlashAttention`, the autograd function whose
backward is :mod:`repro_torch.kernels.flash_attention_bwd` (a kernel on
CUDA tensors, the plain formulas on CPU tensors); :func:`attention` picks
it only where a gradient is wanted, so serving calls launch exactly the
kernel they always did.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def visible(S: int, T: int, causal: bool, window: int,
            device) -> torch.Tensor:
    """(S, T) bool: the keys each query sees, from absolute positions
    (query i sits at T - S + i)."""
    qpos = (T - S) + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    if causal:
        mask = kpos <= qpos
        if window > 0:
            mask = mask & (kpos > qpos - window)
    elif window > 0:
        mask = (kpos - qpos).abs() < window
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=device)
    return mask


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The number of True entries of :func:`visible` (the (query, key)
    pairs the kernel computes), from each query's range of keys."""
    if not causal and window <= 0:
        return S * T
    p = np.arange(S, dtype=np.int64) + (T - S)        # queries' positions
    lo = np.maximum(p - window + 1, 0) if window > 0 else np.zeros_like(p)
    hi = np.minimum(p if causal else p + window - 1, T - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int = 0, return_lse: bool = False
         ) -> tuple:
    """(flops, bytes) of one call, from the shapes: 4 dh a visible pair
    and query head (the two products); q, k and v read once, the output
    (and the log-sum-exp) written once."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    flops = 4 * dh * visible_pairs(S, T, causal, window) * H * B
    nbytes = q.element_size() * 2 * q.numel() + k.element_size() * (
        k.numel() + v.numel()) + (4 * B * H * S if return_lse else 0)
    return flops, nbytes


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True, window: int = 0, return_lse: bool = False):
    """The kernel's function in PyTorch, materialising the scores in f32.
    Masks use absolute positions (query i sits at T - S + i); a row with
    no key left after masking gives 0.  ``return_lse``: also each row's
    log-sum-exp of its scaled scores, (B, H, S) f32, -inf for a row with
    no key."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.float().transpose(1, 2)                             # B,H,S,dh
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = (qf @ kf.transpose(-1, -2)) / math.sqrt(dh)            # B,H,S,T
    s = s.masked_fill(~visible(S, T, causal, window, q.device),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ vf) / torch.where(l == 0, torch.ones_like(l), l)
    o = o.transpose(1, 2).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("-inf")))
    return o, lse[..., 0]


@cuda_lib.accounted("flash_attention", cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, S, H, dh); k, v: (B, T, K, dh).  Returns (B, S, H, dh)
    contiguous, in q's dtype; with ``return_lse`` also the rows'
    log-sum-exp (B, H, S) f32."""
    if q.device.type == "cpu":
        return cuda_lib.kernel_layout(plain(
            q, k, v, causal=causal, window=window, return_lse=return_lse))
    if q.device.type not in ("cuda", "meta"):
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
    lse = torch.empty((B, H, S), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if B == 0 or S == 0 or T == 0:
        if T == 0:                    # no key: zero rows, -inf log-sum-exp
            out.zero_()
            if lse is not None:
                lse.fill_(float("-inf"))
        return (out, lse) if return_lse else out
    if q.device.type == "meta":             # shapes only: nothing launches
        return (out, lse) if return_lse else out
    p = plan(B, S, H, K, dh)
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, K, S, T, dh, _DTYPE[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(max(window, 0)), 1.0 / math.sqrt(dh),
            p.warps, p.key_tile, cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "flash_attention")
    launches.add()
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward keeps q, k, v,
    the output and the rows' log-sum-exp; the backward hands them to
    ``flash_attention_bwd`` (the kernel on CUDA tensors, which raises
    where the kernel does not take the call; the plain formulas on CPU
    tensors).  dO is made contiguous here, not in the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attention_bwd
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """The model's entry: :class:`FlashAttention` where autograd records
    and an input wants a gradient, else :func:`flash_attention` as it
    always ran (no log-sum-exp: the serving path's bits and launches)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
