"""rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
a, b (B, S, W), from an optional initial state h0 (B, W), returning h at
every step (B, S, W) in a's dtype and, on request, the state after step
``n_valid - 1`` (f32): a caller that padded S with trailing zero steps
(which would reset h to 0) still gets the true final state.

Kernel: ``csrc/rglru_scan.cu`` (see its note on what bounds it).  On CUDA
tensors :func:`rglru_scan` launches that kernel or raises; on CPU tensors
it computes :func:`plain`, the sequential definition
(:func:`repro_torch.kernels.ref.rglru`); on meta tensors it checks the
call and returns the outputs' shapes, launching nothing (the backward
too).  :func:`cost` and :func:`cost_bwd` count a call's work.

Training goes through :class:`RGLRUScan`, whose backward is
:func:`rglru_scan_bwd` (``repro_rglru_scan_bwd`` of the same source on
CUDA tensors, :func:`plain_bwd` on CPU tensors); ``ops.rglru_scan`` picks
it only where a gradient is wanted.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib, ref

SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
REPLACES = "src/repro/kernels/rglru_scan.py:38"
launches = cuda_lib.LaunchCounter()
BWD_REPLACES = "src/repro/kernels/ops.py:509"  # XLA's gradient of _xla_rglru
bwd_launches = cuda_lib.LaunchCounter()        # repro_rglru_scan_bwd calls

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
SLICE_LENS = (4, 8, 16)         # slice lengths the kernel is built for
MAX_SLICES = 16


class Plan(NamedTuple):
    """Launch of the kernel: blocks of 32 lanes x ``slices`` slices of
    ``slice_len`` steps; a pass covers slices x slice_len steps."""
    slices: int
    slice_len: int


def plan() -> Plan:
    """Fixed, so slices sit at the same step offsets in every call: a row's
    bits do not depend on B or S.  16 slices of 8 steps: 80 blocks of 512
    threads at recurrentgemma-2b's width, 128 steps a pass.  On an NVIDIA
    H100 80GB HBM3 at 700.00 W, f32 (1, 128, 2560), device ms by
    ``ab.py --sweep`` (slices x steps): 4x16 0.00401, 8x8 0.00320, 8x16
    0.00319, 16x8 0.00274, 16x4 0.00328, 16x16 0.00352; 32-step slices
    spilled (0.0059 at 4x32)."""
    return Plan(16, 8)


def plain(a: torch.Tensor, b: torch.Tensor, *,
          h0: Optional[torch.Tensor] = None, return_state: bool = False,
          n_valid: Optional[int] = None):
    n = a.shape[1] if n_valid is None else int(n_valid)
    y, hn = ref.rglru(a[:, :n], b[:, :n], h0=h0, return_state=True)
    if n < a.shape[1]:
        y = torch.cat([y, ref.rglru(a[:, n:], b[:, n:], h0=hn)], dim=1)
    return (y, hn) if return_state else y


def cost(a: torch.Tensor, b: torch.Tensor, *,
         h0: Optional[torch.Tensor] = None, return_state: bool = False,
         n_valid: Optional[int] = None) -> tuple:
    """(flops, bytes) of one call, from the shapes: a multiply and an add
    a step and lane; a and b (and h0) read once, h at every step (and the
    final state) written once."""
    Bsz, S, W = a.shape
    state = 4 * Bsz * W
    return 2 * Bsz * S * W, (3 * a.element_size() * a.numel()
                             + (state if h0 is not None else 0)
                             + (state if return_state else 0))


def cost_bwd(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor, *,
             h0: Optional[torch.Tensor] = None,
             want_dh0: bool = False) -> tuple:
    """(flops, bytes) of one backward call, from the shapes: three
    operations a step and lane (dh's multiply-add, da's product); a, y
    and g (and h0) read once, da and db (and dh0) written once."""
    Bsz, S, W = a.shape
    state = 4 * Bsz * W
    return 3 * Bsz * S * W, (5 * a.element_size() * a.numel()
                             + (state if h0 is not None else 0)
                             + (state if want_dh0 else 0))


@cuda_lib.accounted("rglru_scan", cost)
def rglru_scan(a: torch.Tensor, b: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None, return_state: bool = False,
               n_valid: Optional[int] = None):
    """a, b: (B, S, W); h0: (B, W) f32.  Returns y, or (y, h) with
    ``return_state``, h the state after step ``n_valid - 1`` (default S
    - 1)."""
    if a.device.type == "cpu":
        return cuda_lib.kernel_layout(plain(a, b, h0=h0,
                                            return_state=return_state,
                                            n_valid=n_valid))
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or a.dtype not in _DTYPE or b.shape != a.shape or \
            b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: a, b must be (B, S, W) of one dtype "
                         f"(float32 or bfloat16), got {a.dtype} "
                         f"{tuple(a.shape)}, {b.dtype} {tuple(b.shape)}")
    Bsz, S, W = a.shape
    n = S if n_valid is None else int(n_valid)
    if not 0 <= n <= S:
        raise ValueError(f"rglru_scan: n_valid {n_valid} outside [0, {S}]")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous on "
                             f"{a.device}")
    if h0 is not None and (tuple(h0.shape) != (Bsz, W) or
                           h0.dtype != torch.float32 or
                           h0.device != a.device or not h0.is_contiguous()):
        raise ValueError(f"rglru_scan: h0 must be contiguous float32 "
                         f"({Bsz}, {W}) on {a.device}, got {h0.dtype} "
                         f"{tuple(h0.shape)} on {h0.device}")
    y = torch.empty_like(a)
    hS = (torch.empty((Bsz, W), dtype=torch.float32, device=a.device)
          if return_state else None)
    if a.numel() == 0:                  # nothing to scan: the state is h0
        if hS is not None:
            hS.copy_(h0 if h0 is not None else torch.zeros_like(hS))
        return (y, hS) if return_state else y
    if a.device.type == "meta":             # shapes only: nothing launches
        return (y, hS) if return_state else y
    p = plan()
    lib = cuda_lib.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_rglru_scan(
            a.data_ptr(), b.data_ptr(), y.data_ptr(),
            None if h0 is None else h0.data_ptr(),
            None if hS is None else hS.data_ptr(), Bsz, S, W, n,
            _DTYPE[a.dtype], p.slices, p.slice_len,
            cuda_lib.stream_ptr(a.device))
    cuda_lib.check(rc, "rglru_scan")
    launches.add()
    return (y, hS) if return_state else y


def plain_bwd(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor, *,
              h0: Optional[torch.Tensor] = None):
    """The backward's formulas in PyTorch (not autograd), from the
    forward's output ``y`` (h at every step) and ``g = dL/dy``: ``dh_t =
    g_t + a_{t+1} dh_{t+1}`` (``a_S = 0``), ``db_t = dh_t``, ``da_t = dh_t
    h_{t-1}`` (``h_{-1}`` = h0 or 0), ``dh0 = a_0 dh_0``.  Returns (da
    like a, db like a, dh0 (B, W) f32 or None where h0 is None)."""
    af, yf, gf = a.float(), y.float(), g.float()
    Bsz, S, W = a.shape
    first = (torch.zeros((Bsz, 1, W), dtype=torch.float32, device=a.device)
             if h0 is None else h0.float()[:, None])
    hprev = torch.cat([first, yf[:, :-1]], dim=1)
    da, db = torch.zeros_like(af), torch.zeros_like(af)
    dh = torch.zeros((Bsz, W), dtype=torch.float32, device=a.device)
    a_next = torch.zeros_like(dh)
    for t in reversed(range(S)):
        dh = gf[:, t] + a_next * dh
        db[:, t] = dh
        da[:, t] = dh * hprev[:, t]
        a_next = af[:, t]
    dh0 = None if h0 is None else a_next * dh
    return da.to(a.dtype), db.to(a.dtype), dh0


@cuda_lib.accounted("rglru_scan_bwd", cost_bwd)
def rglru_scan_bwd(a: torch.Tensor, y: torch.Tensor, g: torch.Tensor, *,
                   h0: Optional[torch.Tensor] = None,
                   want_dh0: bool = False):
    """a, y, g: (B, S, W), y the forward's output from h0 (B, W) f32 or
    0.  Returns (da, db, dh0), dh0 None unless ``want_dh0`` with h0 given.
    The kernel takes float32 only: the model's a and b are
    f32."""
    if a.device.type == "cpu":
        da, db, dh0 = plain_bwd(a, y, g, h0=h0)
        return cuda_lib.kernel_layout((da, db, dh0 if want_dh0 else None))
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_bwd: unsupported device {a.device}")
    if a.dim() != 3 or any(t.shape != a.shape or t.dtype != torch.float32
                           or t.device != a.device for t in (a, y, g)):
        raise ValueError(f"rglru_scan_bwd: a, y, g (B, S, W) float32 on one "
                         f"device, got {a.dtype} {tuple(a.shape)}, {y.dtype} "
                         f"{tuple(y.shape)}, {g.dtype} {tuple(g.shape)}")
    Bsz, S, W = a.shape
    if h0 is not None and (tuple(h0.shape) != (Bsz, W) or
                           h0.dtype != torch.float32 or
                           h0.device != a.device):
        raise ValueError(f"rglru_scan_bwd: h0 must be float32 ({Bsz}, {W}) "
                         f"on {a.device}, got {h0.dtype} {tuple(h0.shape)}")
    a, y, g = a.contiguous(), y.contiguous(), g.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((Bsz, W), dtype=torch.float32,
                      device=a.device) if want_dh0 else None
    if a.numel() == 0:
        for t in (da, db, dh0):
            if t is not None:
                t.zero_()
        return da, db, dh0
    _launch_bwd(a, y, g, h0, da, db, dh0)
    return da, db, dh0


def _launch_bwd(a, y, g, h0, da, db, dh0):
    """One launch of the backward on the current stream; raises if the
    library reports an error, and counts the call only when it
    launched.  On meta tensors nothing launches."""
    if a.device.type == "meta":
        return
    Bsz, S, W = a.shape
    lib = cuda_lib.library()
    with torch.cuda.device(a.device):
        rc = lib.repro_rglru_scan_bwd(
            a.data_ptr(), y.data_ptr(), g.data_ptr(),
            None if h0 is None else h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), None if dh0 is None else dh0.data_ptr(), Bsz, S,
            W, cuda_lib.stream_ptr(a.device))
    cuda_lib.check(rc, "rglru_scan_bwd")
    bwd_launches.add()


class RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` with a gradient: the forward keeps a, its own
    output (the f32 states) and h0; the backward is :func:`rglru_scan_bwd`
    (the kernel on CUDA tensors, which raises where it does not take the
    call; :func:`plain_bwd` on CPU tensors)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        y = rglru_scan(a, b, h0=h0)
        ctx.save_for_backward(a, y, h0)
        return y

    @staticmethod
    def backward(ctx, g):
        a, y, h0 = ctx.saved_tensors
        da, db, dh0 = rglru_scan_bwd(a, y, g.contiguous(), h0=h0,
                                     want_dh0=ctx.needs_input_grad[2])
        return da, db, dh0
