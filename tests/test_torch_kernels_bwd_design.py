"""The tensor-core design of ``flash_attention_bwd`` on the CPU.

``emulate_flash_bwd`` repeats the bf16 kernel's arithmetic in PyTorch: the
tiles of ``flash_attention_bwd.py::plan_bwd`` (the kv pass walks Q / dO
tiles of ``kv_rows`` (position, head) rows, the q pass K / V tiles of
``q_key_tile`` keys), exponentials in the log2 domain from the forward's
lse, P^T and dS^T rounded to bf16 before the products that take them as A
operands, f32 accumulation in tile order, the scale applied last.  It is
held against the kernel's plain version and against ``jax.grad`` of the
reference's ``_xla_flash`` (under ``REPRO_PALLAS=ref``) within phase 27's
bf16 tolerance of each gradient's max |g|.  The plan is held to what the
kernel assumes: every key once in the kv pass, every row once in the q
pass, each walk covering every (row, key) pair the masks keep, tiles fixed
by the padded head dim, shared memory within the H100's 232,448 bytes, and
the constants of ``csrc/flash_attention_bwd.cu`` that it mirrors.  The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 27.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _xla_flash
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import flash_attention_bwd as bmod

torch.set_num_threads(2)
BF16_ATOL = 2e-2              # chip_smoke.py phase 27, of each max |g|
LOG2E = 1.4426950408889634
SOURCE = open(bmod.cuda_lib.CSRC / "flash_attention_bwd.cu").read()


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def emulate_flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """The bf16 kernel's arithmetic (see the module note).  Tiles that the
    kernel skips, or rows it zero-fills, add exact zeros here."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    rep = H // K
    R = S * rep
    p = bmod.plan_bwd(B, S, H, K, dh)
    scale = 1.0 / math.sqrt(dh)
    sl2 = scale * LOG2E

    def rows(t):    # (B, S, H, dh) -> (B, K, R, dh), position-major rows
        return t.float().reshape(B, S, K, rep, dh).permute(0, 2, 1, 3, 4) \
            .reshape(B, K, R, dh)

    def bf(t):
        return t.to(torch.bfloat16).float()

    qr, gr = rows(q), rows(do)
    D = (gr * rows(o)).sum(-1)                                   # B,K,R
    lr = lse.reshape(B, K, rep, S).transpose(2, 3).reshape(B, K, R)
    l2 = torch.where(lr == -math.inf, math.inf, lr * LOG2E)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)
    sees = fmod.visible(S, S, causal, window, "cpu")[torch.arange(R) // rep]
    dk = torch.zeros(B, K, S, dh)
    dv = torch.zeros(B, K, S, dh)
    for r0 in range(0, R, p.kv_rows):
        sl = slice(r0, r0 + p.kv_rows)
        st = kf @ qr[:, :, sl].transpose(-1, -2)                 # B,K,S,rows
        pt = torch.where(sees[sl].T, torch.exp2(st * sl2 - l2[:, :, None, sl]),
                         0.0)
        dst = pt * (vf @ gr[:, :, sl].transpose(-1, -2) - D[:, :, None, sl])
        dv = dv + bf(pt) @ gr[:, :, sl]
        dk = dk + bf(dst) @ qr[:, :, sl]
    dq = torch.zeros(B, K, R, dh)
    for t0 in range(0, S, p.q_key_tile):
        ks = slice(t0, t0 + p.q_key_tile)
        s = qr @ kf[:, :, ks].transpose(-1, -2)                  # B,K,R,keys
        pp = torch.where(sees[:, ks], torch.exp2(s * sl2 - l2[..., None]),
                         0.0)
        ds = pp * (gr @ vf[:, :, ks].transpose(-1, -2) - D[..., None])
        dq = dq + bf(ds) @ kf[:, :, ks]
    dq = (dq * scale).reshape(B, K, S, rep, dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, dh)
    return (dq.to(q.dtype), (dk * scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return np.abs(np.asarray(a, np.float32) - b).max() / max(
        np.abs(b).max(), 1e-30)


# (B, S, H, K, dh, causal, window)
CASES = [(2, 70, 3, 1, 20, True, 0),        # smollm smoke's GQA, dh 20
         (1, 100, 8, 2, 64, True, 16),      # a causal window
         (1, 77, 4, 4, 80, False, 0),       # non-causal (hubert), dh 80
         (1, 90, 32, 8, 120, False, 24),    # h2o-danube's heads, non-causal window
         (1, 40, 4, 2, 256, True, 0)]       # dh 256: two warps a key group


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_vs_plain_and_jax(case):
    B, S, H, K, dh, causal, win = case
    r = np.random.default_rng(sum(case))
    q, do = (torch.from_numpy(r.standard_normal((B, S, H, dh))
                              .astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(r.standard_normal((B, S, K, dh))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    o, lse = fmod.plain(q, k, v, causal=causal, window=win, return_lse=True)
    got = emulate_flash_bwd(q, k, v, o, lse, do, causal=causal, window=win)
    want = bmod.plain(q, k, v, o, lse, do, causal=causal, window=win)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g.float(), w.float()) <= BF16_ATOL
    jq, jk, jv = (jnp.asarray(t.float().transpose(1, 2).numpy())
                  for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b_, c: _xla_flash(
        a, b_, c, causal=causal, window=win), jq, jk, jv)
    jg = vjp(jnp.asarray(do.float().transpose(1, 2).numpy()))
    for g, w in zip(got, jg):
        assert _rel(g.float().transpose(1, 2).numpy(), w) <= BF16_ATOL


def kv_walk(S, rep, j0, rows, causal, window):
    """The kv pass's rows for the block at key j0 (bwd_kv_tc): tiles at
    multiples of ``rows`` from the first row a key of the block sees."""
    j_last = min(S, j0 + bmod.KV_KEYS) - 1
    i_lo, i_hi = 0, S - 1
    if causal:
        i_lo = j0
        if window > 0:
            i_hi = min(i_hi, j_last + window - 1)
    elif window > 0:
        i_lo, i_hi = max(0, j0 - window + 1), min(i_hi, j_last + window - 1)
    r_end = (i_hi + 1) * rep
    t_first = (i_lo * rep // rows) * rows
    return range(t_first, r_end)


def q_walk(S, rep, row0, keys, causal, window):
    """The q pass's keys for the block at row row0 (bwd_q_tc)."""
    R = S * rep
    pos_lo, pos_hi = row0 // rep, (min(R, row0 + bmod.Q_ROWS) - 1) // rep
    k_begin, k_end = 0, S
    if causal:
        k_end = min(S, pos_hi + 1)
        if window > 0:
            k_begin = max(0, pos_lo - window + 1)
    elif window > 0:
        k_begin, k_end = max(0, pos_lo - window + 1), min(S, pos_hi + window)
    return range((k_begin // keys) * keys, k_end)


@pytest.mark.parametrize("shape", [(8, 512, 15, 5, 64), (1, 300, 32, 8, 120),
                                   (1, 128, 10, 1, 256), (2, 100, 6, 2, 20)],
                         ids=lambda s: "-".join(map(str, s)))
def test_plan_covers_every_key_and_row_once(shape):
    B, S, H, K, dh = shape
    rep = H // K
    R = S * rep
    p = bmod.plan_bwd(B, S, H, K, dh)
    tiles_k = p.kv_blocks // (B * K)
    tiles_r = p.q_blocks // (B * K)
    assert tiles_k * B * K == p.kv_blocks and tiles_r * B * K == p.q_blocks
    keys = [j for t in range(tiles_k)
            for j in range(t * p.kv_keys, min(S, (t + 1) * p.kv_keys))]
    assert keys == list(range(S))
    rows = [r for t in range(tiles_r)
            for r in range(t * p.q_rows, min(R, (t + 1) * p.q_rows))]
    assert rows == list(range(R))
    pos = torch.arange(R) // rep
    for causal, win in ((True, 0), (True, 37), (False, 0), (False, 29)):
        sees = fmod.visible(S, S, causal, win, "cpu")[pos]       # R, S
        for t in range(tiles_k):
            j0 = t * p.kv_keys
            walked = torch.zeros(R, dtype=torch.bool)
            walked[list(kv_walk(S, rep, j0, p.kv_rows, causal, win))] = True
            assert not (sees[:, j0:j0 + p.kv_keys].any(1) & ~walked).any()
        for t in range(tiles_r):
            r0 = t * p.q_rows
            walked = torch.zeros(S, dtype=torch.bool)
            walked[list(q_walk(S, rep, r0, p.q_key_tile, causal, win))] = True
            assert not (sees[r0:r0 + p.q_rows].any(0) & ~walked).any()


def test_plan_tiles_fixed_by_the_padded_dim():
    for dh in range(1, 257):
        dp = fmod.padded_dim(dh)
        plans = {bmod.plan_bwd(B, S, H, K, dh)[:3] + bmod.plan_bwd(
            B, S, H, K, dh)[5:7] for B, S, H, K in
            ((1, 1, 1, 1), (8, 512, 15, 5), (1, 4352, 32, 8), (3, 77, 4, 4))}
        split, rows, keys = bmod.TILES[dp]
        assert plans == {(4 * split, bmod.KV_KEYS, rows, bmod.Q_ROWS, keys)}


def test_plan_shared_memory_fits_every_instance():
    for dp in fmod.HEAD_DIMS:
        for rows, keys in (bmod.TILES[dp][1:], bmod.ALT_TILES[dp]):
            assert 0 < bmod.kv_smem_bytes(dp, rows) <= bmod.SMEM_LIMIT
            assert 0 < bmod.q_smem_bytes(dp, keys) <= bmod.SMEM_LIMIT
            # a warp's dK and dV (16 keys, its columns) stay within 128
            # f32 registers a thread
            split = bmod.TILES[dp][0]
            assert 2 * 16 * (dp // split) // 32 <= 128
        # the q pass's blocks an SM fit its shared memory
        q = bmod.plan_bwd(1, 64, 4, 2, dp)
        assert bmod.Q_MIN_BLOCKS[dp] * q.q_smem <= bmod.SM_SMEM


def test_plan_mirrors_the_kernel_source():
    """plan_bwd's constants are csrc's Bk<DP> and shared-memory formulas."""
    for dp in fmod.HEAD_DIMS:
        m = re.search(
            rf"struct Bk<{dp}> {{\s*static constexpr int KV_SPLIT = (\d+), "
            rf"KV_ROWS = (\d+), Q_KEYS = (\d+);\s*static constexpr int "
            rf"KV_ROWS_ALT = (\d+), Q_KEYS_ALT = (\d+);\s*static constexpr "
            rf"int Q_MIN_BLOCKS = (\d+);", SOURCE)
        assert m, dp
        vals = tuple(int(x) for x in m.groups())
        assert vals[:3] == bmod.TILES[dp] and vals[3:5] == bmod.ALT_TILES[dp]
        assert vals[5] == bmod.Q_MIN_BLOCKS[dp]
    assert f"constexpr int KV_KEYS = {bmod.KV_KEYS};" in SOURCE
    assert f"constexpr int Q_ROWS = {bmod.Q_ROWS};" in SOURCE
    assert "return (2 * KV_KEYS + 4 * rows) * (dp + 8) * 2 + 2 * rows * 12;" \
        in SOURCE
    assert "return (2 * Q_ROWS + 4 * keys) * (dp + 8) * 2;" in SOURCE
    assert bmod.kv_smem_bytes(64, 64) == (128 + 256) * 72 * 2 + 64 * 24


def test_source_has_no_atomics_and_uses_the_tensor_cores():
    """No float atomics (the gradients' fixed order, which the trainer's
    bit-equal resume needs); both bf16 passes issue mma.sync."""
    assert "atomicAdd" not in SOURCE
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", SOURCE)
    for kernel in ("bwd_kv_tc", "bwd_q_tc"):
        body = SOURCE.split(f"\n{kernel}(", 1)[1].split("\n}\n", 1)[0]
        assert "mma::mma_bf16" in body and "cp_chunk" in body
