"""The redesigned scans' order of operations, emulated on the CPU.

``rglru_scan`` (``csrc/rglru_scan.cu``): a block holds 32 lanes x NS slices
of T steps; each pass of NS T steps composes every slice's affine map (the
product of its a, its h from 0), combines the maps of the slices before a
slice in slice order from the pass's carry-in, and re-runs the slice from
there; the last slice's final h carries into the next pass.

``ssd_scan`` (``csrc/ssd_scan.cu``, bf16): chunks of L steps from the
call's first step, one block per (batch, head, P columns of dp); in a
chunk the cumulative sum of dt A, G = C B^T with B and C rounded to bf16,
masked (i >= j) before the decay, rounded to bf16 for G (dt x) with dt x
in bf16; the inter term C h^T and the state update (w dt x)^T B with h,
w dt x and B as hi + lo bf16 halves (hi.hi + lo.hi + hi.lo for the
update); f32 accumulation and state.  f32 keeps f32 operands.

Each emulation is held against the port's plain version and the JAX
package's oracle (``repro.kernels.ref`` under ``REPRO_PALLAS=ref``): f32
within 1e-5 of max |out|, bf16 within phase 3's limits (2e-2 of max |out|
for y, 1e-3 for the final state).  And the design's invariants hold: each
row of a B = 2 call equals a B = 1 call bit for bit, and trailing zero
steps leave the valid steps' bits and the final state as they were.
``chip_smoke.py`` phase 3 holds the CUDA kernels to the same invariants."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import rglru_scan as trglru
from repro_torch.kernels import ssd_scan as tssd

torch.set_num_threads(2)
F32_TOL = 1e-5
BF16_TOL = 2e-2                # chip_smoke.py phase 3, of max |out|
STATE_BF16_TOL = 1e-3          # phase 3's final-state limit for bf16 x


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def halves(x: torch.Tensor):
    hi = bf(x)
    return hi, bf(x - hi)


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# rglru_scan: slices, maps in slice order, passes
# ---------------------------------------------------------------------------

def rglru_emul(a, b, h0=None, n_valid=None, plan=None):
    """The kernel's order of operations; rows one at a time, as its blocks
    hold one row each.  Returns (y in a's dtype, state after step
    n_valid - 1)."""
    ns, T = plan or trglru.plan()
    Bz, S, W = a.shape
    n = S if n_valid is None else n_valid
    y = torch.empty((Bz, S, W), dtype=torch.float32)
    hs = torch.zeros((Bz, W))
    for r in range(Bz):
        carry = torch.zeros(W) if h0 is None else h0[r].float().clone()
        if n == 0:
            hs[r] = carry
        for s0 in range(0, S, ns * T):
            steps = [[(a[r, t].float(), b[r, t].float()) if t < S else
                      (torch.ones(W), torch.zeros(W))
                      for t in range(s0 + k * T, s0 + (k + 1) * T)]
                     for k in range(ns)]
            maps = []
            for sl in steps:
                pa, hb = torch.ones(W), torch.zeros(W)
                for av, bv in sl:
                    pa = pa * av
                    hb = av * hb + bv
                maps.append((pa, hb))
            for k, sl in enumerate(steps):
                h = carry
                for pa, hb in maps[:k]:
                    h = pa * h + hb
                for i, (av, bv) in enumerate(sl):
                    h = av * h + bv
                    t = s0 + k * T + i
                    if t < S:
                        y[r, t] = h
                    if t == n - 1:
                        hs[r] = h
                if k == ns - 1:
                    last = h
            carry = last
    return y.to(a.dtype), hs


def rglru_inputs(rng, Bz, S, W, dtype):
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (Bz, S, W)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((Bz, S, W), dtype=np.float32))
    h0 = torch.from_numpy(rng.standard_normal((Bz, W), dtype=np.float32))
    return a.to(dtype), b.to(dtype), h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_slice_composition_matches_plain_and_jax(dtype):
    """Two passes and a ragged third (S 300 over passes of 128), from h0,
    with the state taken at n_valid = S and at a step inside a slice."""
    rng = np.random.default_rng(1)
    a, b, h0 = rglru_inputs(rng, 2, 300, 40, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for n in (300, 211):
        y, hs = rglru_emul(a, b, h0, n_valid=n)
        y_p, h_p = trglru.plain(a, b, h0=h0, return_state=True, n_valid=n)
        y_j, h_j = jref.rglru(jnp.asarray(a[:, :n].float().numpy()),
                              jnp.asarray(b[:, :n].float().numpy()),
                              h0=jnp.asarray(h0.numpy()), return_state=True)
        assert y.dtype == dtype
        assert rel(y.float(), y_p.float()) <= tol
        assert rel(y[:, :n].float(), np.asarray(y_j)) <= tol
        assert rel(hs, h_p) <= F32_TOL and rel(hs, np.asarray(h_j)) <= F32_TOL


def test_rglru_rows_independent_of_batch_and_padding():
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, h0 = rglru_inputs(rng, 2, 150, 24, dtype)
        y, hs = rglru_emul(a, b, h0)
        for r in range(2):
            y1, h1 = rglru_emul(a[r:r + 1], b[r:r + 1], h0[r:r + 1])
            assert torch.equal(y1[0], y[r]) and torch.equal(h1[0], hs[r])
        yp, hp = rglru_emul(F.pad(a, (0, 0, 0, 106)), F.pad(b, (0, 0, 0, 106)),
                            h0, n_valid=150)
        assert torch.equal(yp[:, :150], y) and torch.equal(hp, hs)


# ---------------------------------------------------------------------------
# ssd_scan: chunks from step 0, dp slices, bf16 operands and halves
# ---------------------------------------------------------------------------

def ssd_emul(x, dt, A, B, C, h0=None, plan=None):
    """The kernel's order of operations for one call: (batch, head, dp
    slice) blocks, chunks of L steps from step 0.  Returns (y in x's dtype,
    final state f32)."""
    lowp = x.dtype == torch.bfloat16
    L, P = plan or tssd.plan(x.shape[3], B.shape[2], x.dtype)
    b, nh, S, dp = x.shape
    N = B.shape[2]
    y = torch.zeros((b, nh, S, dp))
    hS = torch.zeros((b, nh, dp, N))
    mask = torch.arange(L)[:, None] >= torch.arange(L)[None, :]
    for r in range(b):
        for h in range(nh):
            for p0 in range(0, dp, P):
                cols = slice(p0, min(p0 + P, dp))
                st = (torch.zeros((cols.stop - p0, N)) if h0 is None
                      else h0[r, h, cols].float().clone())
                for t0 in range(0, S, L):
                    n = min(L, S - t0)
                    Bc, Cc = torch.zeros(L, N), torch.zeros(L, N)
                    dtc, xc = torch.zeros(L), torch.zeros(L, st.shape[0])
                    Bc[:n], Cc[:n] = B[r, t0:t0 + n], C[r, t0:t0 + n]
                    dtc[:n] = dt[r, h, t0:t0 + n]
                    xc[:n] = x[r, h, t0:t0 + n, cols].float()
                    cum = torch.cumsum(dtc * A[h], 0)
                    v = dtc[:, None] * xc
                    w = torch.exp(cum[-1] - cum)[:, None] * v
                    dec = torch.exp(torch.where(
                        mask, cum[:, None] - cum[None, :], -torch.inf))
                    if lowp:
                        Bh, Bl = halves(Bc)
                        Cb = bf(Cc)
                        G = bf((Cb @ Bh.T) * dec)
                        yi = G @ bf(v)
                        hh, hl = halves(st)
                        ye = Cb @ hh.T + Cb @ hl.T
                        wh, wl = halves(w)
                        dH = wh.T @ Bh + wl.T @ Bh + wh.T @ Bl
                    else:
                        yi = ((Cc @ Bc.T) * dec) @ v
                        ye = Cc @ st.T
                        dH = w.T @ Bc
                    yc = yi + torch.exp(cum)[:, None] * ye
                    y[r, h, t0:t0 + n, cols] = yc[:n]
                    st = st * torch.exp(cum[-1]) + dH
                hS[r, h, cols] = st
    return y.to(x.dtype), hS


def ssd_inputs(rng, b, nh, S, dp, N, dtype):
    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return (rn(b, nh, S, dp).to(dtype), rn(b, nh, S).abs() * 0.1 + 0.01,
            -rn(nh).abs() - 0.1, rn(b, S, N) * 0.3, rn(b, S, N) * 0.3,
            rn(b, nh, dp, N) * 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_design_matches_plain_and_jax(dtype):
    """Three chunks and a ragged fourth (S 200 over chunks of 64), dp 48
    over slices of 16, N 24, from h0."""
    rng = np.random.default_rng(3)
    x, dt, A, B, C, h0 = ssd_inputs(rng, 1, 2, 200, 48, 24, dtype)
    y, hS = ssd_emul(x, dt, A, B, C, h0)
    y_p, h_p = tssd.plain(x, dt, A, B, C, h0=h0, return_state=True)
    y_j, h_j = jref.ssd(*(jnp.asarray(t.float().numpy())
                          for t in (x, dt, A, B, C)),
                        h0=jnp.asarray(h0.numpy()), return_state=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert y.dtype == dtype
    assert rel(y.float(), y_p.float()) <= tol
    assert rel(y.float(), np.asarray(y_j)) <= tol
    tol_h = F32_TOL if dtype == torch.float32 else STATE_BF16_TOL
    assert rel(hS, h_p) <= tol_h and rel(hS, np.asarray(h_j)) <= tol_h


def test_ssd_rows_independent_of_batch_and_padding():
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C, h0 = ssd_inputs(rng, 2, 2, 100, 16, 16, dtype)
        y, hS = ssd_emul(x, dt, A, B, C, h0)
        for r in range(2):
            y1, h1 = ssd_emul(x[r:r + 1], dt[r:r + 1], A, B[r:r + 1],
                              C[r:r + 1], h0[r:r + 1])
            assert torch.equal(y1[0], y[r]) and torch.equal(h1[0], hS[r])
        pad = 92                      # past a whole extra chunk of 64
        yp, hp = ssd_emul(F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, pad)), A,
                          F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                          h0)
        assert torch.equal(yp[:, :, :100], y) and torch.equal(hp, hS)


def test_scan_plans_are_fixed_by_geometry():
    """The launch choices never follow B or S: slices and chunks sit at
    fixed offsets from a call's first step.  The plans are among the
    instances the kernels are built for."""
    p = trglru.plan()
    assert p.slice_len in trglru.SLICE_LENS and 1 <= p.slices <= \
        trglru.MAX_SLICES
    for dtype in (torch.float32, torch.bfloat16):
        p = tssd.plan(64, 128, dtype)
        assert tuple(p) in (tssd.BF16_PLANS if dtype == torch.bfloat16
                            else (tssd.F32_PLAN,))
    # ops pads S to its chunk (128): a whole number of the kernel's chunks
    from repro_torch.kernels import ops
    assert ops.SSD_BC % tssd.plan(64, 128, torch.bfloat16).chunk == 0
