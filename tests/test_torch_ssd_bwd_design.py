"""The tensor-core design of ``ssd_scan_bwd`` (bf16) on the CPU.

``emulate_ssd_bwd`` repeats the bf16 kernels' arithmetic in PyTorch, in
the launch that ``ssd_scan.py::plan_bwd`` fixes:

* the walks, in steps of ``walk``: forward, h_prev kept at every
  ``chunk``-step boundary and h <- total h + x^T (rem dt B); reverse, g
  kept after every chunk's last step, dx = dt (bf16(B C^T o L^T) dy + rem
  B g^T) with B, C and g rounded to bf16, and g <- total g + dy^T (e^{cum}
  C); x and dy are exact in bf16, the weighted B and C go in as three bf16
  pieces (hi, mid, lo);
* the heads pass, a chunk and 32 state columns at a time, the heads in
  order: dC = (dy x^T o L o dt) B + e^{cum} dy h_prev and z = (x dy^T o
  L^T) C + rem x g, the decay off the diagonal 16 x 16 tiles a row factor
  times a column factor (about the tile's last or first step, each at most
  1), every f32 operand in three pieces (hi.hi + hi.mid + mid.hi + hi.lo +
  mid.mid + lo.hi), the head sums of dC and dt z in order, r = C.dC and v
  = B.z by column block;
* the finish: the blocks' r and v summed in order, R and W from the last
  step in tiles of 32, ddt = v + A (R - W), dA = sum dt (R - W), the rows
  in index order;

all in f32, the products summed over 16-deep tiles in order.  It is held
against the plain version and against ``jax.vjp`` of the reference's
``_xla_ssd`` (``REPRO_PALLAS=ref``; ``ops.ssd_scan`` where S is ragged):
dx within phase 28's bf16 tolerance, the rest within its f32 one, of each
gradient's max |g|.  A row's bits do not depend on the other rows.  The
plan is held to what the kernels assume: it reads no b or S, covers every
(step, dp row) and state column once, fits shared memory, keeps less
scratch than the f32 design's per-head partials, and mirrors
``csrc/ssd_scan_bwd.cu``.  The CUDA kernels are held to plain on the card
by ``chip_smoke.py`` phase 28.
"""
import inspect
import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels.ops import _xla_ssd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as smod

torch.set_num_threads(2)
BF16_ATOL = 2e-2              # chip_smoke.py phase 28: dx of bf16 x
F32_ATOL = 1e-4               # and the f32 outputs, of each max |g|
SOURCE = open(smod.cuda_lib.CSRC / "ssd_scan_bwd.cu").read()
NAMES = ("dx", "ddt", "dA", "dB", "dC")
SMEM_LIMIT = 232448           # bytes of shared memory a block may opt in to
FIN_WARPS = 8                 # batch rows a finish block at once


def walk_smem_bytes(walk: int, cols: int) -> int:
    """csrc walk_smem_bytes: B and C rows (five of walk x (128 + 8) bf16),
    g's hi (cols x 136), x or dy (walk x (cols + 8)), dt and cum."""
    return (5 * walk + cols) * (smod.MAX_N + 8) * 2 + \
        walk * (cols + 8) * 2 + 2 * walk * 4


def heads_smem_bytes(chunk: int) -> int:
    """csrc heads_smem_bytes: two buffers of x and dy rows, of h_prev and g
    (f32) and of dt and cum; the decay's column factors; the pieces of
    h_prev, g, B and C."""
    dp, sc = smod.BWD_MAX_DP, smod.BWD_STATE_COLS
    return 4 * chunk * (dp + 8) * 2 + 4 * dp * sc * 4 + 6 * chunk * 4 + \
        6 * dp * (sc + 8) * 2 + 6 * chunk * (sc + 8) * 2


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def pieces(t: torch.Tensor, n: int = 3) -> tuple:
    """t as three bf16 pieces, hi + mid + lo (n = 2: hi, lo and a zero
    third, the forward's two halves)."""
    hi = bf(t)
    mid = bf(t - hi)
    return hi, mid, bf(t - hi - mid) if n == 3 else torch.zeros_like(t)


def tiled(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """acc + a @ b, summed over 16-deep k tiles in order."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 16):
        out = out + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def three(a: tuple, b: tuple, acc: torch.Tensor) -> torch.Tensor:
    """acc + a . b with both sides in three pieces, the six terms in the
    kernels' order, tile by tile."""
    for k0 in range(0, a[0].shape[-1], 16):
        s = slice(k0, k0 + 16)
        for i, j in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)):
            acc = acc + a[i][..., s] @ b[j][..., s, :]
    return acc


def exact_three(a: torch.Tensor, b: tuple, acc: torch.Tensor) -> torch.Tensor:
    """acc + a . b, a exact in bf16, b in three pieces."""
    for k0 in range(0, a.shape[-1], 16):
        s = slice(k0, k0 + 16)
        for j in range(3):
            acc = acc + a[..., s] @ b[j][..., s, :]
    return acc


def emulate_ssd_bwd(x, dt, A, B, C, dy, h0=None, n_pieces=3):
    """The bf16 kernels' arithmetic (see the module note); returns (dx in
    bf16, ddt, dA, dB, dC) as ``ssd_scan_bwd`` does.  ``n_pieces`` 2 takes
    the f32 operands in two pieces instead of three."""
    b, nh, S, dp = x.shape
    N = B.shape[-1]
    p = smod.plan_bwd(dp, N, x.dtype)
    Q, L, keep = p.chunk, p.walk, p.chunk // p.walk
    ns, nq = -(-S // L), -(-S // Q)
    pad = nq * Q - S
    xf = F.pad(x.float(), (0, 0, 0, pad))
    yf = F.pad(dy.float(), (0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, pad))
    Bf = F.pad(B.float(), (0, 0, 0, pad))[:, None]
    Cf = F.pad(C.float(), (0, 0, 0, pad))[:, None]
    a = A.float()[None, :, None]
    i_ = torch.arange(L)
    upper = i_[None, :] >= i_[:, None]                 # [i, k]: k >= i
    hs = torch.zeros(b, nh, nq, dp, N)
    gs = torch.zeros(b, nh, nq, dp, N)
    cumq = torch.zeros(b, nh, nq * Q)
    dx = torch.zeros(b, nh, nq * Q, dp)
    # forward walk
    h = torch.zeros(b, nh, dp, N) if h0 is None else h0.float().clone()
    base = torch.zeros(b, nh)
    for c in range(ns):
        st = slice(c * L, (c + 1) * L)
        if c % keep == 0:
            hs[:, :, c // keep] = h
            base = torch.zeros(b, nh)
        cum = torch.cumsum(dtf[..., st] * a, -1)
        cumq[..., st] = base[..., None] + cum
        w = torch.exp(cum[..., -1:] - cum) * dtf[..., st]
        h = exact_three(xf[:, :, st].transpose(-1, -2),
                        pieces(w[..., None] * Bf[:, :, st], n_pieces),
                        torch.exp(cum[..., -1])[..., None, None] * h)
        base = base + cum[..., -1]
    for c in range(ns, nq * keep):        # a kept chunk shorter than Q
        cumq[..., c * L:(c + 1) * L] = base[..., None]
    # reverse walk
    g = torch.zeros(b, nh, dp, N)
    for c in reversed(range(ns)):
        st = slice(c * L, (c + 1) * L)
        if c % keep == keep - 1 or c == ns - 1:
            gs[:, :, c // keep] = g
        cum = torch.cumsum(dtf[..., st] * a, -1)
        gq = tiled(bf(Bf[:, :, st]), bf(Cf[:, :, st]).transpose(-1, -2))
        dec = torch.exp(torch.where(upper, cum[..., None, :] -
                                    cum[..., :, None], 0.0))
        gq = bf(torch.where(upper, gq * dec, 0.0))
        di = tiled(gq, yf[:, :, st])
        de = tiled(bf(Bf[:, :, st]), bf(g).transpose(-1, -2))
        rem = torch.exp(cum[..., -1:] - cum)[..., None]
        dx[:, :, st] = dtf[..., st, None] * (di + rem * de)
        g = exact_three(yf[:, :, st].transpose(-1, -2),
                        pieces(torch.exp(cum)[..., None] * Cf[:, :, st], n_pieces),
                        torch.exp(cum[..., -1])[..., None, None] * g)
    # heads pass, chunk by chunk, the heads in order
    sc = p.state_cols
    nsl = -(-N // sc)
    npad = nsl * sc
    iq = torch.arange(Q)
    lower_q = iq[:, None] >= iq[None, :]               # [i, j]: j <= i
    upper_q = ~lower_q | (iq[:, None] == iq[None, :])  # [i, k]: k >= i
    tile = iq // 16
    diag = tile[:, None] == tile[None, :]              # the diagonal tiles
    dB = torch.zeros(b, nq * Q, N)
    dC = torch.zeros(b, nq * Q, N)
    rs = torch.zeros(b, nh, nq * Q, nsl)
    vs = torch.zeros(b, nh, nq * Q, nsl)
    for c in range(nq):
        st = slice(c * Q, (c + 1) * Q)
        b3, c3 = pieces(Bf[:, 0, st], n_pieces), pieces(Cf[:, 0, st], n_pieces)
        brec = (b3[0] + b3[1]) + b3[2]
        crec = (c3[0] + c3[1]) + c3[2]
        dcs = torch.zeros(b, Q, N)
        dbs = torch.zeros(b, Q, N)
        for hh in range(nh):
            cm = cumq[:, hh, st]
            dtc = dtf[:, hh, st]
            xq, yq = xf[:, hh, st], yf[:, hh, st]
            # off the diagonal tiles a row factor times a column factor
            # about the tile's last (dC) or first (z) step
            ce = cm[..., tile * 16 + 15]                     # by column
            cs = cm[..., tile * 16]
            m = tiled(yq, xq.transpose(-1, -2))              # [i, j]
            dec = torch.exp(torch.where(lower_q, cm[..., :, None] -
                                        cm[..., None, :], 0.0))
            p1 = torch.where(diag, m * dec * dtc[..., None, :],
                             m * torch.exp(cm[..., :, None] - ce[..., None, :])
                             * (torch.exp(ce - cm) * dtc)[..., None, :])
            p1 = torch.where(lower_q, p1, 0.0)
            dci = three(pieces(p1, n_pieces), b3, torch.zeros(b, Q, N))
            dce = exact_three(yq, pieces(hs[:, hh, c], n_pieces), torch.zeros(b, Q, N))
            dCh = dci + torch.exp(cm)[..., None] * dce
            dcs = dcs + dCh
            mt = tiled(xq, yq.transpose(-1, -2))             # [i, k]
            dec = torch.exp(torch.where(upper_q, cm[..., None, :] -
                                        cm[..., :, None], 0.0))
            p2 = torch.where(diag, mt * dec,
                             mt * torch.exp(cs[..., None, :] - cm[..., :, None])
                             * torch.exp(cm - cs)[..., None, :])
            p2 = torch.where(upper_q, p2, 0.0)
            zi = three(pieces(p2, n_pieces), c3, torch.zeros(b, Q, N))
            ze = exact_three(xq, pieces(gs[:, hh, c], n_pieces), torch.zeros(b, Q, N))
            z = zi + torch.exp(cm[..., -1:] - cm)[..., None] * ze
            dbs = dbs + dtc[..., None] * z
            rs[:, hh, st] = F.pad(crec * dCh, (0, npad - N)).reshape(
                b, Q, nsl, sc).sum(-1)
            vs[:, hh, st] = F.pad(brec * z, (0, npad - N)).reshape(
                b, Q, nsl, sc).sum(-1)
        dB[:, st], dC[:, st] = dbs, dcs
    # finish: r and v summed over the column blocks in order, then R and W
    # from the last step in tiles of 32
    r = torch.zeros(b, nh, S)
    v = torch.zeros(b, nh, S)
    for q in range(nsl):
        r = r + rs[..., :S, q]
        v = v + vs[..., :S, q]
    dts = dt.float()
    R = torch.zeros(b, nh)
    W = torch.zeros(b, nh)
    ddt = torch.zeros(b, nh, S)
    dA_l = torch.zeros(b, nh, 32)
    for t0 in reversed(range(0, S, 32)):
        k = slice(t0, min(S, t0 + 32))
        rsum = r[..., k].flip(-1).cumsum(-1).flip(-1)
        wsum = (dts[..., k] * v[..., k]).flip(-1).cumsum(-1).flip(-1)
        sd = (R[..., None] + rsum) - (W[..., None] + wsum)
        ddt[..., k] = v[..., k] + A.float()[None, :, None] * sd
        dA_l[..., :sd.shape[-1]] += dts[..., k] * sd
        R, W = R + rsum[..., 0], W + wsum[..., 0]
    dA_rows = dA_l.sum(-1)
    dA = torch.zeros(nh)
    for row in range(b):
        dA = dA + dA_rows[row]
    return (dx[:, :, :S].to(x.dtype), ddt, dA, dB[:, :S], dC[:, :S])


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max() /
                 max(np.abs(b).max(), 1e-30))


def ssd_inputs(r, b, nh, S, dp, N, with_h0=False):
    """bf16 x and dy, f32 dt > 0, A < 0, B, C (and h0), from numpy."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    x = t(r.standard_normal((b, nh, S, dp))).to(torch.bfloat16)
    dt = t(np.abs(r.standard_normal((b, nh, S))) * 0.3 + 0.02)
    A = t(-np.abs(r.standard_normal(nh)) - 0.2)
    B = t(r.standard_normal((b, S, N)) * 0.5)
    C = t(r.standard_normal((b, S, N)) * 0.5)
    dy = t(r.standard_normal((b, nh, S, dp))).to(torch.bfloat16)
    h0 = t(r.standard_normal((b, nh, dp, N)) * 0.5) if with_h0 else None
    return x, dt, A, B, C, dy, h0


def check(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        tol = BF16_ATOL if name == "dx" else F32_ATOL
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, name)
        assert _rel(g.float().numpy(), w) <= tol, (what, name)


# (b, nh, S, dp, N, bc, h0): test_torch_kernels_scan_bwd.py's SSD cases, a
# ragged S over two kept chunks and a short last one, and a start from h0
CASES = [(2, 3, 32, 8, 5, 16, False), (1, 2, 24, 16, 16, 24, False),
         (2, 8, 48, 16, 16, 16, False), (1, 3, 200, 32, 20, 8, False),
         (2, 2, 150, 16, 40, 0, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_vs_plain_and_jax(case):
    b, nh, S, dp, N, bc, with_h0 = case
    r = np.random.default_rng(sum(case))
    x, dt, A, B, C, dy, h0 = ssd_inputs(r, b, nh, S, dp, N, with_h0)
    got = emulate_ssd_bwd(x, dt, A, B, C, dy, h0)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    check(got, smod.plain_bwd(x, dt, A, B, C, dy, h0=h0), "plain")
    ins = [x.float(), dt, A, B, C]
    if with_h0:                # the reference has no h0: the oracle's autograd
        ts = [t.clone().requires_grad_() for t in ins]
        want = torch.autograd.grad(ref.ssd(*ts, h0=h0), ts, dy.float())
        check(got, want, "autograd")
        return
    jin = [jnp.asarray(t.numpy()) for t in ins]
    if S % bc:
        fn = lambda *a: jops.ssd_scan(*a, bc=bc)
    else:
        fn = lambda *a: _xla_ssd(*a, bc=bc)
    _, vjp = jax.vjp(fn, *jin)
    check(got, vjp(jnp.asarray(dy.float().numpy())), "jax")


def test_two_pieces_do_not_hold_dA():
    """Why the f32 operands take three pieces: dA's suffix-sum form sums
    D_k (r_k - dt_k v_k) with D_k = dt_1 + .. + dt_k, terms far larger than
    dA, so r and v need about f32's precision.  At S 512 with phase 28's
    input scale (dt about 0.1) the two-piece design (the forward's) leaves
    dA beyond 1e-4 of max |dA| from an f64 autograd of the sequential
    oracle while dB, dC and ddt hold; three pieces come as near as the f32
    plain version.  ``-s`` prints the drifts."""
    r = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    b, nh, S, dp, N = 1, 2, 512, 32, 64
    x = t(r.standard_normal((b, nh, S, dp))).to(torch.bfloat16)
    dt = t(np.abs(r.standard_normal((b, nh, S))) * 0.1 + 0.01)
    A = t(-np.abs(r.standard_normal(nh)) - 0.1)
    B = t(r.standard_normal((b, S, N)) * 0.3)
    C = t(r.standard_normal((b, S, N)) * 0.3)
    dy = t(r.standard_normal((b, nh, S, dp))).to(torch.bfloat16)
    ins = [u.double().requires_grad_() for u in (x, dt, A, B, C)]
    want = torch.autograd.grad(ref.ssd(*ins), ins, dy.double())
    two = emulate_ssd_bwd(x, dt, A, B, C, dy, n_pieces=2)
    three = emulate_ssd_bwd(x, dt, A, B, C, dy)
    plain = smod.plain_bwd(x, dt, A, B, C, dy)
    drift = {name: [_rel(g[i].float().numpy(), want[i].numpy())
                    for i in (1, 2, 3, 4)] for name, g in
             (("two pieces", two), ("three pieces", three),
              ("f32 plain", plain))}
    print("\nddt/dA/dB/dC of max |g| from f64: " + "; ".join(
        f"{k} " + "/".join(f"{e:.2e}" for e in v) for k, v in drift.items()))
    assert drift["two pieces"][1] > F32_ATOL
    assert max(drift["two pieces"][i] for i in (0, 2, 3)) <= F32_ATOL
    assert max(drift["three pieces"]) <= F32_ATOL
    assert drift["three pieces"][1] <= 2 * drift["f32 plain"][1]


def test_rows_bit_equal_at_any_batch():
    """Each row of a b = 3 call equals its b = 1 call bit for bit (dx, ddt,
    dB, dC): no sum crosses rows but dA's."""
    r = np.random.default_rng(7)
    x, dt, A, B, C, dy, h0 = ssd_inputs(r, 3, 2, 140, 16, 24, True)
    many = emulate_ssd_bwd(x, dt, A, B, C, dy, h0)
    for row in range(3):
        s = slice(row, row + 1)
        one = emulate_ssd_bwd(x[s], dt[s], A, B[s], C[s], dy[s], h0[s])
        for i in (0, 1, 3, 4):
            assert torch.equal(many[i][s], one[i]), (row, NAMES[i])


def test_failing_launch_raises_and_counts_nothing(monkeypatch):
    """A bf16 launch the library refuses raises in the launch step and adds
    nothing to the count, with scratch shaped by ``bwd_scratch``."""
    import contextlib

    class Failing:
        def __getattr__(self, name):
            return lambda *a: 700            # cudaErrorIllegalAddress
    monkeypatch.setattr(smod.cuda_lib, "library", lambda: Failing())
    monkeypatch.setattr(smod.cuda_lib, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    b, nh, S, dp, N = 1, 2, 40, 16, 20
    x = torch.zeros(b, nh, S, dp, dtype=torch.bfloat16)
    dt = torch.zeros(b, nh, S)
    B = torch.zeros(b, S, N)
    p = smod.plan_bwd(dp, N, x.dtype)
    scratch = smod.bwd_scratch(b, nh, S, dp, N, p, "cpu")
    assert [tuple(t.shape) for t in scratch] == [
        (1, 2, 1, 16, 32), (1, 2, 1, 16, 32), (2, 1, 2, 128), (1, 2, 40, 1),
        (1, 2, 40, 1)]
    before = smod.bwd_launches.value
    with pytest.raises(RuntimeError, match="ssd_scan_bwd: CUDA launch"):
        smod._launch_bwd_tc(x, dt, dt[0, :, 0], B, B, None, x, x.clone(),
                            dt.clone(), dt[0, :, 0].clone(), B.clone(),
                            B.clone(), *scratch, plan=p)
    assert smod.bwd_launches.value == before


def test_plan_reads_no_batch_or_length():
    """plan_bwd takes (dp, N, dtype) alone; bf16 takes the first instance
    at every dp from 33 to 64, the second (32 rows a walk block) up to 32,
    at every N up to 128, and raises above; it refuses f32, which keeps the
    first design's rows a thread (bwd_rows)."""
    assert list(inspect.signature(smod.plan_bwd).parameters) == \
        ["dp", "N", "dtype"]
    for dp in range(1, smod.BWD_MAX_DP + 1):
        want = smod.BwdPlan(*smod.BWD_TC_PLANS[0 if dp > 32 else 1],
                            smod.BWD_STATE_COLS)
        assert want.cols >= dp and want.chunk == 128 and want.walk == 64
        for N in (1, 5, 16, 20, 100, 128):
            assert smod.plan_bwd(dp, N, torch.bfloat16) == want
        assert smod.bwd_rows(dp) >= dp
        with pytest.raises(ValueError):
            smod.plan_bwd(dp, 16, torch.float32)
    for dp, N in ((65, 16), (16, 129), (16, 0)):
        with pytest.raises(ValueError):
            smod.plan_bwd(dp, N, torch.bfloat16)


def test_plan_covers_every_step_row_and_column_once():
    """The walk blocks' rows, the walks' steps, the kept states' chunks and
    the heads pass's (chunk, column) blocks each cover their range once at
    every instance, from shapes alone."""
    for S, (Q, L, P) in itertools.product((1, 63, 64, 65, 128, 300, 512),
                                          smod.BWD_TC_PLANS):
        assert Q % L == 0 and L % 16 == 0 and P % 16 == 0
        for dp in (8, 16, 20, 32, 64):
            rows = [p for s in range(-(-dp // P))
                    for p in range(s * P, min(dp, (s + 1) * P))]
            assert rows == list(range(dp))
        steps = [t for c in range(-(-S // L))
                 for t in range(c * L, min(S, (c + 1) * L))]
        assert steps == list(range(S))
        keep = Q // L
        # the forward walk keeps h at a chunk's first step, the reverse
        # walk g at its last (or the call's last): one each a chunk
        ns = -(-S // L)
        fwd = [c // keep for c in range(ns) if c % keep == 0]
        rev = [c // keep for c in range(ns)
               if c % keep == keep - 1 or c == ns - 1]
        assert fwd == sorted(set(rev)) == list(range(-(-S // Q)))
        for N in (5, 16, 128):
            sc = smod.BWD_STATE_COLS
            cols = [n for s in range(-(-N // sc))
                    for n in range(s * sc, min(N, (s + 1) * sc))]
            assert cols == list(range(N))


def test_shared_memory_and_scratch():
    """Every instance fits the H100's 232,448 bytes a block (the plan's walk
    two blocks an SM); the scratch at mamba2-780m's training shape is under
    the f32 design's 403 MB of per-head partials, written and read."""
    for Q, L, P in smod.BWD_TC_PLANS:
        assert 0 < walk_smem_bytes(L, P) <= SMEM_LIMIT
        assert 0 < heads_smem_bytes(Q) <= SMEM_LIMIT
    for dp in (16, 64):
        p = smod.plan_bwd(dp, 128, torch.bfloat16)
        assert 2 * (walk_smem_bytes(p.walk, p.cols) + 1024) <= 233472
    p = smod.plan_bwd(64, 128, torch.bfloat16)
    b, nh, S, dp, N = 8, 48, 512, 64, 128
    scratch = smod.bwd_scratch(b, nh, S, dp, N, p, "meta")
    moved = 2 * sum(t.numel() * 4 for t in scratch)     # written, read
    partials = 2 * 2 * b * nh * S * N * 4
    assert partials == 402653184
    assert moved < 0.6 * partials                       # 230 of 403 MB


def test_plan_mirrors_the_kernel_source():
    """The constants and shared-memory formulas of csrc/ssd_scan_bwd.cu,
    and its bf16 instances, are the plan's."""
    for name, value in (("NMAX", smod.MAX_N), ("DPMAX", smod.BWD_MAX_DP),
                        ("SCOLS", smod.BWD_STATE_COLS),
                        ("FIN_WARPS", FIN_WARPS),
                        ("MAX_SMEM", SMEM_LIMIT)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name
    assert "return (5 * L + P) * (NMAX + 8) * 2 + L * (P + 8) * 2 + " \
        "2 * L * 4;" in SOURCE
    assert "return 4 * L * (DPMAX + 8) * 2 + 4 * DPMAX * SCOLS * 4 + " \
        "6 * L * 4 +\n         6 * DPMAX * (SCOLS + 8) * 2 + " \
        "6 * L * (SCOLS + 8) * 2;" in SOURCE
    assert walk_smem_bytes(64, 64) == (5 * 64 + 64) * 136 * 2 + \
        64 * 72 * 2 + 2 * 64 * 4
    for q in (64, 128):
        assert heads_smem_bytes(q) == 4 * q * 72 * 2 + 4 * 64 * 32 * 4 \
            + 6 * q * 4 + 6 * 64 * 40 * 2 + 6 * q * 40 * 2
    built = [tuple(int(v) for v in m) for m in re.findall(
        r"REPRO_SSD_WALK\((\d+), (\d+), (\d+)\);", SOURCE)]
    assert built == list(smod.BWD_TC_PLANS)
    assert set(int(q) for q in re.findall(r"launch_heads<(\d+)>\(", SOURCE)) \
        == {q for q, _, _ in smod.BWD_TC_PLANS}


def test_source_has_no_float_atomics_and_uses_the_tensor_cores():
    """No atomics (the fixed order the trainer's bit-equal steps need); the
    walk and heads kernels issue mma.sync and stage by cp.async."""
    assert "atomicAdd" not in SOURCE
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", SOURCE)
    for kernel in ("ssd_bwd_walk", "ssd_bwd_heads"):
        body = SOURCE.split(f"\n{kernel}(", 1)[1].split("\n}\n", 1)[0]
        assert "mma::mma_bf16" in body and "cp_chunk" in body, kernel
