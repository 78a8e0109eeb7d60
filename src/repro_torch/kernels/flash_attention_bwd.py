"""flash_attention_bwd: the gradient of :mod:`flash_attention` (q (B, S, H,
dh), k/v (B, S, K, dh), GQA by kv head ``h // rep``; causal, causal with a
window, or non-causal), from the forward's output and its rows'
log-sum-exp.

Kernel: ``csrc/flash_attention_bwd.cu`` (see its note).  On CUDA tensors
:func:`flash_attention_bwd` launches it or raises (S != T, a head dim
above 256, other dtypes); on CPU tensors it computes :func:`plain`; on
meta tensors it checks the call and returns the gradients' shapes,
launching nothing (:func:`cost` counts its work).  The
JAX package has no backward kernel: ``jax.grad`` differentiates its
pure-jnp flash attention, which :data:`REPLACES` names.  :func:`plan_bwd`
gives the bf16 kernel's tiles and blocks.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention import (HEAD_DIMS, padded_dim,
                                                 visible, visible_pairs)

SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/ops.py:215"      # XLA's gradient of _xla_flash
launches = cuda_lib.LaunchCounter()

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

KV_KEYS = 64            # keys a kv-pass block: 4 warps of 16 (8 at DP 256)
Q_ROWS = 64             # (position, head) rows a q-pass block: 4 warps of 16
# per padded dim, the bf16 kernel's Bk<DP>: (warps sharing 16 keys in the kv
# pass, rows a Q/dO tile of the kv pass, keys a K/V tile of the q pass)
TILES = {32: (1, 64, 64), 64: (1, 64, 32), 128: (1, 64, 64),
         256: (2, 32, 32)}
# the (kv rows, q keys) each padded dim is also built at, for ab.py --sweep
ALT_TILES = {32: (64, 64), 64: (32, 64), 128: (32, 32), 256: (32, 32)}
# blocks an SM the q pass at the plan's key tile is compiled for
Q_MIN_BLOCKS = {32: 1, 64: 4, 128: 1, 256: 1}
SMEM_LIMIT = 232448     # bytes of shared memory a block may opt in to
SM_SMEM = 233472        # bytes of shared memory an SM holds for its blocks


class PlanBwd(NamedTuple):
    """Launch of the bf16 kernel: the kv pass in ``kv_blocks`` blocks of
    ``kv_warps`` warps, each over ``kv_keys`` keys, walking Q/dO tiles of
    ``kv_rows`` (position, head) rows in ``kv_smem`` bytes of shared
    memory; the q pass in ``q_blocks`` blocks of 4 warps, each over
    ``q_rows`` rows, walking K/V tiles of ``q_key_tile`` keys in
    ``q_smem`` bytes."""
    kv_warps: int
    kv_keys: int
    kv_rows: int
    kv_blocks: int
    kv_smem: int
    q_rows: int
    q_key_tile: int
    q_blocks: int
    q_smem: int


def kv_smem_bytes(dp: int, rows: int) -> int:
    """csrc kv_smem_bytes: K and V tiles, two buffers each of Q and dO
    rows (8 bf16 of padding a row) and of the rows' lse, D and position."""
    return (2 * KV_KEYS + 4 * rows) * (dp + 8) * 2 + 2 * rows * 12


def q_smem_bytes(dp: int, keys: int) -> int:
    """csrc q_smem_bytes: Q and dO rows, two buffers each of K and V."""
    return (2 * Q_ROWS + 4 * keys) * (dp + 8) * 2


def plan_bwd(B: int, S: int, H: int, K: int, dh: int) -> PlanBwd:
    """The bf16 kernel's launch: its tiles are fixed by the padded head dim
    alone; blocks cover every key once in the kv pass and every (position,
    head) row once in the q pass."""
    dp = padded_dim(dh)
    split, kv_rows, q_keys = TILES[dp]
    rep = H // K
    return PlanBwd(
        kv_warps=4 * split, kv_keys=KV_KEYS, kv_rows=kv_rows,
        kv_blocks=B * K * -(-S // KV_KEYS),
        kv_smem=kv_smem_bytes(dp, kv_rows), q_rows=Q_ROWS,
        q_key_tile=q_keys, q_blocks=B * K * -(-S * rep // Q_ROWS),
        q_smem=q_smem_bytes(dp, q_keys))


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
          causal: bool = True, window: int = 0):
    """The kernel's formulas in PyTorch, in f32 (not autograd):
    ``P = exp(s - lse)`` (0 where masked or where the row has no key),
    ``D = rowsum(dO * o)``, ``dV = P^T dO``, ``dS = P (dO v^T - D)``,
    ``dQ = scale dS k``, ``dK = scale dS^T q``, the rep query heads of a
    kv head summed into its dK and dV.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep = H // K
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().transpose(1, 2)                             # B,H,S,dh
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    dof = do.float().transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * scale                    # B,H,S,T
    keep = visible(S, T, causal, window, q.device) & \
        torch.isfinite(lse)[..., None]
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    D = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - D)
    dq = (ds @ kf) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).reshape(B, K, rep, T, dh)
    dv = (p.transpose(-1, -2) @ dof).reshape(B, K, rep, T, dh)
    return (dq.transpose(1, 2).to(q.dtype),
            dk.sum(2).transpose(1, 2).to(k.dtype),
            dv.sum(2).transpose(1, 2).to(v.dtype))


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
         lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
         window: int = 0) -> tuple:
    """(flops, bytes) of one call, from the shapes: 2.5 times the
    forward's products (five products of a visible pair where the forward
    has two); q, k, v, o, dO and lse read once, dq, dk and dv written
    once."""
    B, S, H, dh = q.shape
    T = k.shape[1]
    flops = 10 * dh * visible_pairs(S, T, causal, window) * H * B
    nbytes = q.element_size() * 4 * q.numel() + k.element_size() * 4 * \
        k.numel() + lse.element_size() * lse.numel()
    return flops, nbytes


@cuda_lib.accounted("flash_attention_bwd", cost)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """q, o, do: (B, S, H, dh); k, v: (B, S, K, dh); lse: (B, H, S) f32.
    Returns (dq, dk, dv), contiguous, in the inputs' dtype."""
    if q.device.type == "cpu":
        return cuda_lib.kernel_layout(plain(q, k, v, o, lse, do,
                                            causal=causal, window=window))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    if T != S:
        raise ValueError(f"flash_attention_bwd: the kernel takes S = T (what "
                         f"training reaches), got S={S}, T={T}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh or \
            K == 0 or H % K or o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (B, H, S):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}")
    if not 1 <= dh <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention_bwd: head dim {dh} not supported "
                         f"by the kernel (1 to {HEAD_DIMS[-1]})")
    if q.dtype not in _DTYPE or lse.dtype != torch.float32 or \
            any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention_bwd: q, k, v, o, do float32 or "
                         f"bfloat16 (all equal) and lse float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, "
                         f"{do.dtype}, {lse.dtype}")
    ts = [t.contiguous() for t in (q, k, v, o, do, lse)]
    if any(t.device != q.device for t in ts):
        raise ValueError("flash_attention_bwd: all inputs on one device")
    dq = torch.empty_like(ts[0])
    dk = torch.empty_like(ts[1])
    dv = torch.empty_like(ts[2])
    if B == 0 or S == 0:
        return dq, dk, dv
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch(*ts, dq, dk, dv, D, causal=causal, window=window)
    return dq, dk, dv


def _launch(q, k, v, o, do, lse, dq, dk, dv, D, *, causal: bool,
            window: int):
    """One call of the backward's three kernels on the current stream;
    raises if the library reports an error, and counts the call only when
    it launched.  On meta tensors nothing launches."""
    if q.device.type == "meta":
        return
    B, S, H, dh = q.shape
    K = k.shape[2]
    p = plan_bwd(B, S, H, K, dh)
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), D.data_ptr(), B, H, K, S, dh, _DTYPE[q.dtype],
            int(causal), int(max(window, 0)), 1.0 / math.sqrt(dh),
            p.kv_rows, p.q_key_tile, cuda_lib.stream_ptr(q.device))
    cuda_lib.check(rc, "flash_attention_bwd")
    launches.add()
