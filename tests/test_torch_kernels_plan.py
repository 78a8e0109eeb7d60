"""The launch plans of the two tensor-core kernels, and their rounding
emulated on the CPU.

``quant_matmul.py::plan`` fixes the split over K from (K, N) alone, so a
row's result does not depend on M; at a 4-row decode step every
projection of smollm-360m, mamba2-780m and recurrentgemma-2b spreads over
at least 132 blocks.  ``flash_attention.py::plan`` picks the warps of a
block; the key tile is fixed by the head dim.

The emulations repeat the kernels' arithmetic in PyTorch: ``quant_matmul``
sums the exact products x . w in f32 per K slice, adds the slice sums in
slice order and applies the scale last; ``flash_attention`` runs the
online softmax over key tiles at absolute positions in the log2 domain and
rounds P to bf16 before P V.  Each is held against the kernel's plain
version and against the JAX package's oracle (``repro.kernels.ref``, under
``REPRO_PALLAS=ref``) with phase 3's tolerance for bf16 (2e-2: relative
to max |out| for quant_matmul, absolute for attention).  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import tree
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models import transformer
from repro_torch.models.api import get_config

torch.set_num_threads(2)
BF16_ATOL = 2e-2              # chip_smoke.py phase 3


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def projections(arch):
    """(K, N) of every weight contraction of the model at full width, as
    ``quant.einsum`` collapses it (``wo`` contracts its two leading axes);
    the head is the tied embedding where the model has no head leaf."""
    cfg = get_config(arch)
    model = transformer.build(cfg, device="cpu")
    shapes = set()
    for name in model.unit_names():
        for path, leaf in tree.leaves_with_path(model.abstract_unit(name)):
            if path[-1] == "tok":
                shapes.add((leaf.shape[1], leaf.shape[0]))     # tied head
            elif leaf.dim() >= 2 and path[-1] != "conv":
                nc = 2 if path[-1] == "wo" else 1
                shapes.add((math.prod(leaf.shape[:nc]),
                            math.prod(leaf.shape[nc:])))
    return sorted(shapes)


def blocks(k, n, m):
    p = tqm.plan(k, n)
    ls = tqm.launch_shape(p, m, n)
    return -(-n // tqm.TILE_N) * -(-m // ls.bm) * ls.groups


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_qmm_plan_fills_the_card_at_decode(arch):
    shapes = projections(arch)
    assert len(shapes) >= 3
    for k, n in shapes:
        assert blocks(k, n, 4) >= tqm.SMS, (arch, k, n, tqm.plan(k, n))


def test_qmm_plan_depends_on_k_and_n_only():
    for k, n in projections("smollm-360m") + [(70, 33), (300, 5), (64, 8192),
                                             (2560, 256), (7680, 2560)]:
        p = tqm.plan(k, n)
        assert p == tqm.plan(k, n)
        assert p.slice_k % tqm.KSTEP == 0
        assert (p.n_slices - 1) * p.slice_k < k <= p.n_slices * p.slice_k
        for m in (1, 3, 4, 16, 37, 64, 128, 1000):
            ls = tqm.launch_shape(p, m, n)
            # M picks only the tiling and whether the slices run in one
            # block or in one block each: the same additions in order
            assert ls.groups in (1, p.n_slices)
            assert ls.bm in (8, 32)


def test_flash_plan_covers_every_row_with_a_fixed_key_tile():
    for B, S, H, K, dh in [(1, 128, 15, 5, 64), (1, 128, 10, 1, 256),
                           (1, 1000, 15, 5, 64), (2, 70, 8, 2, 128)]:
        p = tflash.plan(B, S, H, K, dh)
        rows = 16 * p.warps               # (position, head) rows a block
        assert p.key_tile == tflash.KEY_TILE[dh]
        assert p.blocks == B * K * -(-S * (H // K) // rows)
        # the key tile, and so every addition of a row, is the same
        # whatever S and the packing of heads
        assert all(tflash.plan(B, s, h, K, dh).key_tile == p.key_tile
                   for s in (1, 64, 4096) for h in (K, H))


def emulate_qmm(x, w, scale, plan):
    """The bf16 kernel's arithmetic: exact products summed in f32 within
    each K slice, the slice sums added in slice order, times the scale,
    rounded to bf16."""
    xf, wf = x.float(), w.float()
    tot = None
    for s in range(plan.n_slices):
        lo, hi = s * plan.slice_k, min(x.shape[1], (s + 1) * plan.slice_k)
        part = xf[:, lo:hi] @ wf[lo:hi]
        tot = part if tot is None else tot + part
    return (tot * scale).to(torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(4, 960, 49152), (4, 960, 320),
                                   (128, 960, 2560), (128, 2560, 960)])
def test_qmm_emulation_vs_plain_and_jax(m, k, n):
    rng = np.random.default_rng(m * 7 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wt, st = torch.from_numpy(w), torch.from_numpy(s)
    got = emulate_qmm(xb, wt, st, tqm.plan(k, n)).float()
    want = tqm.plain(xb, wt, st).float()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= BF16_ATOL * scale
    jwant = np.asarray(jref.quant_matmul(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(s)).astype(jnp.float32))
    assert np.abs(got.numpy() - jwant).max() <= BF16_ATOL * scale


def emulate_flash(q, k, v, *, causal=True, window=0):
    """The bf16 kernel's arithmetic, per (position, head) row: key tiles of
    ``KEY_TILE[dh]`` at absolute positions, scores in f32 scaled into the
    log2 domain, running max and f32 sum of P, P rounded to bf16 for P V,
    O / l rounded to bf16 (0 for a row with no key)."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    rep, bkv = H // K, tflash.KEY_TILE[dh]
    scale_log2 = (1.0 / math.sqrt(dh)) * 1.4426950408889634
    qf = q.float().transpose(1, 2)                               # B,H,S,dh
    kf = k.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    qpos = (T - S) + torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -math.inf)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, dh))
    for t0 in range(0, T, bkv):
        kpos = torch.arange(t0, min(T, t0 + bkv))[None, :]
        ok = torch.ones((S, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok = kpos <= qpos
            if window > 0:
                ok = ok & (kpos > qpos - window)
        elif window > 0:
            ok = (kpos - qpos).abs() < window
        s = (qf @ kf[:, :, t0:t0 + bkv].transpose(-1, -2)) * scale_log2
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() @ vf[:, :, t0:t0 + bkv]
        acc = acc * alpha + pv
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,T,H,K,dh,causal,window", [
    (1, 128, 128, 15, 5, 64, True, 0),        # smollm prefill
    (1, 128, 128, 10, 1, 256, True, 0),       # recurrentgemma prefill
    (1, 64, 128, 15, 5, 64, True, 0),         # prefill_continue
    (2, 77, 77, 4, 2, 256, False, 16)])       # windowed, not causal
def test_flash_emulation_vs_plain_and_jax(B, S, T, H, K, dh, causal, window):
    rng = np.random.default_rng(S * 3 + T + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((B, S, H, dh), (B, T, K, dh), (B, T, K, dh)))
    got = emulate_flash(q, k, v, causal=causal, window=window).float()
    want = tflash.plain(q, k, v, causal=causal, window=window).float()
    assert (got - want).abs().max().item() <= BF16_ATOL
    if S == T:      # the JAX oracle measures positions from 0 (queue 3)
        jq, jk, jv = (jnp.asarray(t.float().transpose(1, 2).numpy())
                      .astype(jnp.bfloat16) for t in (q, k, v))
        jwant = np.asarray(jref.mha_attention(
            jq, jk, jv, causal=causal, window=window).astype(jnp.float32))
        assert np.abs(got.transpose(1, 2).numpy() - jwant).max() <= BF16_ATOL


def test_flash_emulation_rows_independent_of_s():
    """With key tiles at absolute positions a row's arithmetic does not
    depend on S: the last 64 queries at T = 128 equal the last 64 rows of
    the S = T = 128 call bit for bit (chip_smoke.py checks the kernel)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16)
               for shape in ((1, 128, 15, 64), (1, 128, 5, 64),
                             (1, 128, 5, 64)))
    full = emulate_flash(q, k, v)
    assert torch.equal(emulate_flash(q[:, 64:], k, v), full[:, 64:])


def test_cuda_lib_hash_covers_headers(tmp_path, monkeypatch):
    for src in cuda_lib.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    before = cuda_lib.source_hash()
    (tmp_path / "mma.cuh").write_text((tmp_path / "mma.cuh").read_text()
                                      + "\n// edited\n")
    assert cuda_lib.source_hash() != before
