"""rmsnorm: RMS normalisation over the last axis, ``x / sqrt(mean(x^2) +
eps) * (1 + scale)`` in f32, rounded once into x's dtype.

Kernel: ``csrc/rmsnorm.cu`` (see its note: a row's bits do not depend on
how many rows a call holds, which the decode scheduler's bit-identity
with ``reference_generate`` needs).  On CUDA tensors :func:`rmsnorm`
launches that kernel or raises; on CPU tensors it computes :func:`plain`.
The launch is :func:`plan`'s, from d and the dtypes alone.

Training goes through :class:`RMSNorm`, whose backward is
:func:`rmsnorm_bwd` (the same source's ``repro_rmsnorm_bwd`` on CUDA
tensors, :func:`plain_bwd` on CPU tensors); :func:`norm` picks it only
where a gradient is wanted.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib

SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
REPLACES = "src/repro/models/layers.py:44"      # XLA's, not a TPU kernel
launches = cuda_lib.LaunchCounter()
bwd_launches = cuda_lib.LaunchCounter()      # repro_rmsnorm_bwd calls

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# rmsnorm.cu's constants
BLOCK = 256            # threads a block at most (teams x threads a row)
CHUNK_BYTES = 16       # a chunk of x: 8 bf16 or 4 f32, one load
MAX_CHUNKS = 16        # chunks a thread at most (instances 1, 2, 4, 8, 16)
REDUCE_COLS = 32       # the backward's pass 2: columns a block
REDUCE_WARPS = 8       # ... and warps a block, over the partial rows
SMEM_LIMIT = 48 * 1024     # pass 1's team sums in shared memory
# the plan's choices
WARP_CHUNKS = 4        # chunks a thread where one warp takes a row
ROW_CHUNKS = 2         # chunks a thread at most where a row takes more warps
FWD_BLOCK = 128        # threads a block of the forward (at least a row's)
BWD_TEAM_ROWS = 4      # rows a team of the backward's pass 1


class Plan(NamedTuple):
    """A launch of both kernels: ``threads`` share a row (a warp, or 2, 4
    or 8 warps); a forward block holds ``rows`` rows, a team of
    ``threads`` each; a block of the backward's first pass has
    :func:`bwd_teams` teams and takes ``bwd_rows`` rows, a team every
    teams-th; ``vec`` elements an access (16 bytes' worth, or 1 where d
    is not a multiple of it)."""
    threads: int
    rows: int
    bwd_rows: int
    vec: int


def bwd_teams(p: Plan) -> int:
    """Teams (rows at once) a block of the backward's first pass."""
    return BLOCK // p.threads


def chunk_elems(dtype: torch.dtype) -> int:
    """Elements of one chunk of x: 8 bf16 or 4 f32."""
    return CHUNK_BYTES // _ITEMSIZE[dtype]


def chunks_a_thread(d: int, dtype: torch.dtype, threads: int) -> int:
    """The instance a launch takes (rmsnorm.cu's ``check_launch``): the
    power of two at least the chunks each of ``threads`` threads holds."""
    chunks = -(-d // chunk_elems(dtype))
    per = -(-chunks // threads)
    return 1 << max(0, per - 1).bit_length()


@functools.lru_cache(maxsize=None)
def plan(d: int, x_dtype: torch.dtype, scale_dtype: torch.dtype) -> Plan:
    """The launch for rows of d elements: one warp a row where a thread
    then holds ``WARP_CHUNKS`` chunks or fewer, else the fewest warps that
    keep it at ``ROW_CHUNKS`` (8 warps past that).  The forward's blocks
    hold ``FWD_BLOCK`` threads (one row's where a row takes more), a row a
    team; the backward's ``BLOCK``, ``BWD_TEAM_ROWS`` rows a team.  It
    takes no row count, so a row's order of operations, and its bits, are
    the same at any batch."""
    if x_dtype not in _KIND or scale_dtype not in _KIND or d <= 0:
        raise ValueError(f"rmsnorm: no plan for d {d}, x {x_dtype}, "
                         f"scale {scale_dtype}")
    v = chunk_elems(x_dtype)
    chunks = -(-d // v)
    threads = 32 if chunks <= 32 * WARP_CHUNKS else next(
        (t for t in (64, 128) if chunks <= t * ROW_CHUNKS), BLOCK)
    if chunks_a_thread(d, x_dtype, threads) > MAX_CHUNKS:
        raise ValueError(f"rmsnorm: d {d} exceeds {BLOCK * MAX_CHUNKS * v} "
                         f"for {x_dtype}")
    return Plan(threads, max(1, FWD_BLOCK // threads),
                BLOCK // threads * BWD_TEAM_ROWS, v if d % v == 0 else 1)


def bwd_blocks(p: Plan, rows: int) -> int:
    """Blocks of the backward's pass 1, and rows of its f64 partial of
    dscale: from (rows, d) alone, never from the card."""
    return -(-rows // p.bwd_rows)


def _vec(p: Plan, *tensors) -> int:
    """The plan's access width, or 1 where a pointer is not 16-byte
    aligned (the same chunks and order, so the same bits)."""
    return p.vec if all(t.data_ptr() % CHUNK_BYTES == 0
                        for t in tensors) else 1


def plain(x: torch.Tensor, scale: torch.Tensor,
          eps: float = 1e-6) -> torch.Tensor:
    """The reference's rmsnorm in PyTorch, op for op."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def cost(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> tuple:
    """(flops, bytes) of one call, from the shapes: four operations an
    element (square, sum, scale, weight); x and the scale read once, the
    output written once."""
    return 4 * x.numel(), (2 * x.element_size() * x.numel()
                           + scale.element_size() * scale.numel())


def cost_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
             eps: float = 1e-6) -> tuple:
    """(flops, bytes) of one backward call, from the shapes: ten
    operations an element; x, g and the scale read once, dx and dscale
    written once."""
    return 10 * x.numel(), (3 * x.element_size() * x.numel()
                            + 2 * scale.element_size() * scale.numel())


@cuda_lib.accounted("rmsnorm", cost)
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16; scale: (d,) float32 or bfloat16.
    Returns x's shape and dtype."""
    if x.device.type == "cpu":
        return cuda_lib.kernel_layout(plain(x, scale, eps))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _KIND or scale.dtype not in _KIND or \
            tuple(scale.shape) != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: x (..., d) and scale (d,) float32 or "
                         f"bfloat16 on one device, got {x.dtype} "
                         f"{tuple(x.shape)}, {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    x, sc = x.contiguous(), scale.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    p = plan(d, x.dtype, sc.dtype)
    if x.device.type == "meta":             # shapes only: nothing launches
        return y
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm(x.data_ptr(), sc.data_ptr(), y.data_ptr(),
                               rows, d, float(eps), _KIND[x.dtype],
                               _KIND[sc.dtype], p.threads, p.rows, 1,
                               _vec(p, x, sc, y),
                               cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "rmsnorm")
    launches.add()
    return y


def plain_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
              eps: float = 1e-6):
    """The backward's formulas in PyTorch (not autograd), with ``w = 1 +
    scale`` and ``r = rsqrt(mean(x^2) + eps)``: ``dx = r g w - x r^3
    mean(g w x)`` in x's dtype, ``dscale = sum over rows of g x r`` in
    scale's dtype."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gw = gf * (1.0 + scale.float())
    dx = r * gw - xf * r.pow(3) * (gw * xf).mean(dim=-1, keepdim=True)
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


@cuda_lib.accounted("rmsnorm_bwd", cost_bwd)
def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                eps: float = 1e-6):
    """x, g: (..., d) in one dtype; scale (d,).  Returns (dx like x,
    dscale like scale)."""
    if x.device.type == "cpu":
        return cuda_lib.kernel_layout(plain_bwd(x, scale, g, eps))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _KIND or scale.dtype not in _KIND or \
            g.dtype != x.dtype or g.shape != x.shape or \
            tuple(scale.shape) != (d,) or d < 1 or \
            scale.device != x.device or g.device != x.device:
        raise ValueError(f"rmsnorm_bwd: x and g (..., d) in one dtype, "
                         f"scale (d,), float32 or bfloat16 on one device, "
                         f"got {x.dtype} {tuple(x.shape)}, {g.dtype} "
                         f"{tuple(g.shape)}, {scale.dtype} "
                         f"{tuple(scale.shape)}")
    x, g, sc = x.contiguous(), g.contiguous(), scale.contiguous()
    dx = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return dx, torch.zeros_like(scale)
    p = plan(d, x.dtype, sc.dtype)
    partial = torch.empty((bwd_blocks(p, rows), d), dtype=torch.float64,
                          device=x.device)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    _launch_bwd(x, sc, g, dx, partial, dscale, rows, d, eps)
    return dx, dscale.to(scale.dtype)


def _launch_bwd(x, scale, g, dx, partial, dscale, rows: int, d: int,
                eps: float):
    """One call of the backward's two kernels on the current stream, by
    :func:`plan`; raises if the library reports an error, and counts the
    call only when it launched.  On meta tensors nothing launches."""
    if x.device.type == "meta":
        return
    p = plan(d, x.dtype, scale.dtype)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), rows, d, float(eps),
            _KIND[x.dtype], _KIND[scale.dtype], p.threads, bwd_teams(p),
            p.bwd_rows // bwd_teams(p), _vec(p, x, scale, g, dx),
            cuda_lib.stream_ptr(x.device))
    cuda_lib.check(rc, "rmsnorm_bwd")
    bwd_launches.add()


class RMSNorm(torch.autograd.Function):
    """:func:`rmsnorm` with a gradient: the forward keeps x and the scale,
    the backward is :func:`rmsnorm_bwd` (the kernel on CUDA tensors, which
    raises where it does not take the call; :func:`plain_bwd` on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        x = x.contiguous()
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None


def norm(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    """The model's entry: :class:`RMSNorm` where autograd records and an
    input wants a gradient, else :func:`rmsnorm` as it always ran."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm(x, scale, eps)
