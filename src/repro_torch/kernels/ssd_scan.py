"""ssd_scan: the Mamba-2 SSD scan, x (b, nh, S, dp) with step sizes dt
(b, nh, S) > 0, decay rates A (nh,) < 0 and shared projections B, C
(b, S, N), from an optional initial state h0 (b, nh, dp, N), returning y
(b, nh, S, dp) in x's dtype and, on request, the final state (f32).

Kernel: ``csrc/ssd_scan.cu`` (see its note on what bounds it).  On CUDA
tensors :func:`ssd_scan` launches that kernel or raises; on CPU tensors
it computes :func:`plain`, the sequential definition
(:func:`repro_torch.kernels.ref.ssd`).

Training goes through :class:`SSDScan`, whose backward is
:func:`ssd_scan_bwd` (``csrc/ssd_scan_bwd.cu`` on CUDA tensors,
:func:`plain_bwd` on CPU tensors); ``ops.ssd_scan`` picks it only where a
gradient is wanted.  Its bf16 design runs on the tensor cores in chunks
that :func:`plan_bwd` fixes; f32 keeps the first design (a thread a state
column, :func:`bwd_rows`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = "src/repro/kernels/ssd_scan.py:73"
launches = cuda_lib.LaunchCounter()
BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
BWD_REPLACES = "src/repro/kernels/ops.py:411"  # XLA's gradient of _xla_ssd
bwd_launches = cuda_lib.LaunchCounter()        # repro_ssd_scan_bwd calls
BWD_ROWS = (16, 32, 64)         # dp rows a thread, the f32 backward's instances
BWD_MAX_N = 128                 # a thread a column of the state
# (chunk, walk, cols) instances of the bf16 backward (csrc
# repro_ssd_scan_bwd_tc): states kept and the heads pass in chunks of Q
# steps, the walks in steps of L, P rows of dp a walk block.  The first two
# are the plan's (dp above 32, dp up to 32); the third, 64-step chunks, is
# there for ab.py --sweep
BWD_TC_PLANS = ((128, 64, 64), (128, 64, 32), (64, 64, 64))
BWD_STATE_COLS = 32             # state columns a heads-pass block (SCOLS)
BWD_MAX_DP = 64                 # head dim the bf16 backward takes (DPMAX)

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 128                     # state width the bf16 kernel takes
# (chunk, cols) instances of the bf16 kernel; f32 runs (64, 16)
BF16_PLANS = ((64, 16), (64, 32), (64, 64), (32, 16), (128, 16))
F32_PLAN = (64, 16)


class Plan(NamedTuple):
    """Launch of the kernel: chunks of ``chunk`` steps from the call's first
    step, ``cols`` columns of dp a block."""
    chunk: int
    cols: int


def plan(dp: int, N: int, dtype: torch.dtype) -> Plan:
    """The chunk length and dp columns a block, from the head geometry and
    dtype alone (never B or S), so that a row's chunks, and so its bits,
    are the same in any batch and under trailing padding.

    bf16: 64-step chunks (four warps of 16 rows), 16 columns a block: 192
    blocks at mamba2-780m's 48 heads of dp 64.  On an NVIDIA H100 80GB
    HBM3 at 700.00 W, x (1, 48, 128, 64) bf16, N 128, device ms by
    ``ab.py --sweep`` (chunk x columns): 64x16 0.01919, 64x32 0.02276,
    64x64 0.03651, 32x16 0.03165, 128x16 0.02552.  f32 takes the one
    instance of its design."""
    del dp, N
    return Plan(*(BF16_PLANS[0] if dtype == torch.bfloat16 else F32_PLAN))


def plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor, *,
          h0: Optional[torch.Tensor] = None, return_state: bool = False):
    return ref.ssd(x, dt, A, B, C, h0=h0, return_state=return_state)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Shapes as in :func:`repro_torch.kernels.ref.ssd`.  Returns y, or
    (y, h_S) with ``return_state``."""
    if x.device.type == "cpu":
        return plain(x, dt, A, B, C, h0=h0, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE:
        raise ValueError(f"ssd_scan: x must be (b, nh, S, dp) float32 or "
                         f"bfloat16, got {x.dtype} {tuple(x.shape)}")
    b, nh, S, dp = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": (dt, (b, nh, S)), "A": (A, (nh,)), "B": (B, (b, S, N)),
            "C": (C, (b, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (b, nh, dp, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous float32 "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not x.is_contiguous():
        raise ValueError(f"ssd_scan: x must be contiguous, got strides "
                         f"{x.stride()}")
    if x.dtype == torch.bfloat16 and N > MAX_N:
        raise ValueError(f"ssd_scan: state width {N} above the bf16 "
                         f"kernel's {MAX_N}")
    y = torch.empty_like(x)
    hS = (torch.empty((b, nh, dp, N), dtype=torch.float32, device=x.device)
          if return_state else None)
    if x.numel() == 0:                  # nothing to scan: the state is h0
        if hS is not None:
            hS.copy_(h0 if h0 is not None else torch.zeros_like(hS))
        return (y, hS) if return_state else y
    p = plan(dp, N, x.dtype)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), None if hS is None else hS.data_ptr(), b, nh, S,
            dp, N, _DTYPE[x.dtype], p.chunk, p.cols,
            cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ssd_scan")
    launches.add()
    return (y, hS) if return_state else y


class BwdPlan(NamedTuple):
    """Launch of the bf16 backward: states kept, and the heads pass run, in
    chunks of ``chunk`` steps from the call's first step; the walks in steps
    of ``walk``, ``cols`` rows of dp a walk block; ``state_cols`` columns of
    the state a heads-pass block."""
    chunk: int
    walk: int
    cols: int
    state_cols: int


def plan_bwd(dp: int, N: int, dtype: torch.dtype) -> BwdPlan:
    """The bf16 backward's launch from the head geometry alone (never b or
    S), so a row's chunks, and so its bits, are the same in any batch.

    States kept every 128 steps (b nh (S / Q) dp N f32 each, half of what
    64-step chunks keep), walks in steps of 64 with every row of dp in one
    block (one B C^T a step for all of dp): 32 rows where dp is at most 32,
    else 64; 32 state columns a heads-pass block.  The rows a walk block
    take change no bits.  Raises where the kernels do not take the shape:
    another dtype (f32 runs the first design, :func:`bwd_rows`), dp above
    64, N above 128."""
    if dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan_bwd: the chunked design takes bf16 x, "
                         f"got {dtype}")
    if not 1 <= N <= BWD_MAX_N:
        raise ValueError(f"ssd_scan_bwd: state width {N} outside the "
                         f"kernel's 1 to {BWD_MAX_N}")
    if not 1 <= dp <= BWD_MAX_DP:
        raise ValueError(f"ssd_scan_bwd: head dim {dp} outside the bf16 "
                         f"kernel's 1 to {BWD_MAX_DP}")
    return BwdPlan(*BWD_TC_PLANS[0 if dp > 32 else 1], BWD_STATE_COLS)


def bwd_scratch(b: int, nh: int, S: int, dp: int, N: int, p: BwdPlan,
                device) -> tuple:
    """The bf16 backward's float32 scratch: the states h_prev and g at
    every chunk's start (b, nh, chunks, dp, N rounded up to the columns), the
    chunks' dt and cum, and r and v by column block."""
    nc = -(-S // p.chunk)
    npad = -(-N // p.state_cols) * p.state_cols
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((b, nh, nc, dp, npad), **f32),
            torch.empty((b, nh, nc, dp, npad), **f32),
            torch.empty((2, b, nh, nc * p.chunk), **f32),
            torch.empty((b, nh, S, npad // p.state_cols), **f32),
            torch.empty((b, nh, S, npad // p.state_cols), **f32))


def bwd_rows(dp: int) -> int:
    """The backward's instance for head dim ``dp``: the least of
    :data:`BWD_ROWS` at or above it."""
    for rows in BWD_ROWS:
        if dp <= rows:
            return rows
    raise ValueError(f"ssd_scan_bwd: head dim {dp} above the kernel's "
                     f"{BWD_ROWS[-1]}")


def plain_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None):
    """The backward's formulas in PyTorch, in f32 (not autograd).  A
    forward walk recomputes h_t (from h0) for ``dC_t = h_t^T dy_t`` and
    ``r_t = C_t . dC_t``; a backward walk carries ``dh_t = dy_t C_t^T +
    a_{t+1} dh_{t+1}`` for ``z_t = dh_t^T x_t``, ``dB_t = dt_t z_t``,
    ``v_t = B_t . z_t`` and ``dx_t = dt_t dh_t B_t``; then with the suffix
    sums ``R_t`` of r and ``W_t`` of ``dt v``, ``a_t <h_{t-1}, dh_t> = R_t -
    W_t`` gives ``ddt_t = v_t + A (R_t - W_t)`` and ``dA = sum dt (R -
    W)``.  dB and dC sum over heads.  Returns (dx in x's dtype, ddt (b, nh,
    S), dA (nh,), dB, dC (b, S, N)) in f32."""
    b, nh, S, dp = x.shape
    N = B.shape[-1]
    xf, dtf, Af, Bf, Cf, dyf = (t.float() for t in (x, dt, A, B, C, dy))
    h = (torch.zeros((b, nh, dp, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    dC_h = torch.zeros((b, nh, S, N), dtype=torch.float32, device=x.device)
    r = torch.zeros((b, nh, S), dtype=torch.float32, device=x.device)
    for t in range(S):
        decay = torch.exp(dtf[:, :, t] * Af[None, :])
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, :, t], xf[:, :, t], Bf[:, t])
        dC_h[:, :, t] = torch.einsum("bhpn,bhp->bhn", h, dyf[:, :, t])
        r[:, :, t] = torch.einsum("bhn,bn->bh", dC_h[:, :, t], Cf[:, t])
    dh = torch.zeros_like(h)
    a_next = torch.zeros((b, nh), dtype=torch.float32, device=x.device)
    dx = torch.zeros_like(xf)
    dB_h = torch.zeros_like(dC_h)
    v = torch.zeros_like(r)
    for t in reversed(range(S)):
        dh = dh * a_next[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", dyf[:, :, t], Cf[:, t])
        z = torch.einsum("bhpn,bhp->bhn", dh, xf[:, :, t])
        dB_h[:, :, t] = dtf[:, :, t, None] * z
        v[:, :, t] = torch.einsum("bhn,bn->bh", z, Bf[:, t])
        dx[:, :, t] = dtf[:, :, t, None] * torch.einsum(
            "bhpn,bn->bhp", dh, Bf[:, t])
        a_next = torch.exp(dtf[:, :, t] * Af[None, :])
    R = r.flip(-1).cumsum(-1).flip(-1)
    Ws = (dtf * v).flip(-1).cumsum(-1).flip(-1)
    sd = R - Ws
    ddt = v + Af[None, :, None] * sd
    dA = (dtf * sd).sum(dim=(0, 2))
    return dx.to(x.dtype), ddt, dA, dB_h.sum(1), dC_h.sum(1)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
                 h0: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssd_scan`'s y: shapes as there, dy like x.
    Returns (dx like x, ddt (b, nh, S), dA (nh,), dB, dC (b, S, N)), all
    but dx in f32."""
    if x.device.type == "cpu":
        return plain_bwd(x, dt, A, B, C, dy, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE or dy.shape != x.shape or \
            dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: x and dy (b, nh, S, dp) of one "
                         f"dtype (float32 or bfloat16), got {x.dtype} "
                         f"{tuple(x.shape)}, {dy.dtype} {tuple(dy.shape)}")
    b, nh, S, dp = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": (dt, (b, nh, S)), "A": (A, (nh,)), "B": (B, (b, S, N)),
            "C": (C, (b, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (b, nh, dp, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {name} must be contiguous "
                             f"float32 {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= N <= BWD_MAX_N:
        raise ValueError(f"ssd_scan_bwd: state width {N} outside the "
                         f"kernel's 1 to {BWD_MAX_N}")
    if x.dtype == torch.bfloat16:
        plan = plan_bwd(dp, N, x.dtype)
    else:
        rows = bwd_rows(dp)
    x, dy = x.contiguous(), dy.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((b, nh, S), **f32)
    dA = torch.empty((nh,), **f32)
    dB = torch.empty((b, S, N), **f32)
    dC = torch.empty((b, S, N), **f32)
    if x.numel() == 0:
        for t in (dx, ddt, dA, dB, dC):
            t.zero_()
        return dx, ddt, dA, dB, dC
    if x.dtype == torch.bfloat16:
        _launch_bwd_tc(x, dt, A, B, C, h0, dy, dx, ddt, dA, dB, dC,
                       *bwd_scratch(b, nh, S, dp, N, plan, x.device),
                       plan=plan)
        return dx, ddt, dA, dB, dC
    scratch = (torch.empty((b, nh, S, N), **f32),
               torch.empty((b, nh, S, N), **f32), torch.empty((b, nh), **f32))
    _launch_bwd(x, dt, A, B, C, h0, dy, dx, ddt, dA, dB, dC, *scratch,
                rows=rows)
    return dx, ddt, dA, dB, dC


def _launch_bwd(x, dt, A, B, C, h0, dy, dx, ddt, dA, dB, dC, dB_h, dC_h,
                dA_h, *, rows: int):
    """One call of the f32 backward's two kernels on the current stream;
    raises if the library reports an error, and counts the call only when
    it launched."""
    b, nh, S, dp = x.shape
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dB_h.data_ptr(), dC_h.data_ptr(),
            dA_h.data_ptr(), b, nh, S, dp, B.shape[-1], _DTYPE[x.dtype],
            rows, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ssd_scan_bwd")
    bwd_launches.add()


def _launch_bwd_tc(x, dt, A, B, C, h0, dy, dx, ddt, dA, dB, dC, hs, gs,
                   dtc, rs, vs, *, plan: BwdPlan):
    """One call of the bf16 backward's three kernels on the current stream
    (scratch from :func:`bwd_scratch`); raises if the library reports an
    error, and counts the call once, only when it launched."""
    b, nh, S, dp = x.shape
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd_scan_bwd_tc(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if h0 is None else h0.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), hs.data_ptr(), gs.data_ptr(),
            dtc.data_ptr(), rs.data_ptr(), vs.data_ptr(), b, nh, S, dp,
            B.shape[-1], plan.chunk, plan.walk, plan.cols, hs.shape[-1],
            cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "ssd_scan_bwd")
    bwd_launches.add()


class SSDScan(torch.autograd.Function):
    """:func:`ssd_scan` with a gradient: the forward keeps its inputs (the
    backward recomputes the states), the backward is :func:`ssd_scan_bwd`
    (the kernel on CUDA tensors, which raises where it does not take the
    call; :func:`plain_bwd` on CPU tensors).  The initial state takes no
    gradient: training starts every sequence from 0."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        ctx.save_for_backward(x, dt, A, B, C, h0)
        return ssd_scan(x, dt, A, B, C, h0=h0)

    @staticmethod
    def backward(ctx, dy):
        if ctx.needs_input_grad[5]:
            raise NotImplementedError(
                "ssd_scan: no gradient for the initial state h0")
        x, dt, A, B, C, h0 = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_scan_bwd(x, dt, A, B, C,
                                           dy.contiguous(), h0=h0)
        return dx, ddt, dA, dB, dC, None
