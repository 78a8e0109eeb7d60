"""The decode kernels' split over the cache: ``decode_attention.py::plan``
and the split's arithmetic emulated on the CPU.

``plan(K, rep, dh)`` fixes ``split_len`` from the head geometry alone, and
a row's splits are ``[s L, (s+1) L)`` within ``[0, n_keys)``.  The
emulation repeats ``csrc/decode_attention.cu``: per split, bf16 runs
16-key chunks dealt round-robin to ``min(4, L / 16)`` warps (scores in f32
in the log2 domain, P rounded to bf16 for P V, the sum of P in f32), the
warps' statistics combined in warp order; f32 walks the split in the FMA
body's tiles without rounding; then a row's splits are merged in split
order in one online pass.  It is held against the port's plain versions
and the JAX package's oracle (``repro.kernels.ref``, under
``REPRO_PALLAS=ref``): bf16 within phase 3's ``BF16_ATOL`` (2e-2,
absolute), f32 within 1e-5.  The
CUDA kernels are held to the same invariants on the card by
``chip_smoke.py`` (rows bit-equal across B, cache lengths and pages).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode

torch.set_num_threads(2)
BF16_ATOL = 2e-2              # chip_smoke.py phase 3
F32_ATOL = 1e-5
LOG2E = 1.4426950408889634
# (K, rep, dh) of smollm-360m, recurrentgemma-2b, and other GQA shapes
GEOMETRIES = [(5, 3, 64), (1, 10, 256), (2, 4, 128), (8, 1, 64),
              (2, 4, 256), (4, 16, 64)]


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def slot_valid(j, pos, window):
    """The reference's validity of slot j (ref.decode_attention)."""
    if window > 0:
        held = pos - (pos - j) % window
        return held >= 0 and held > pos - window
    return j <= pos


def n_keys(pos, s_ext, window=0):
    """Cache rows a row at ``pos`` may read, ``[0, n_keys)`` of a cache of
    ``s_ext`` logical rows (the kernels' ``n_keys_of``)."""
    n = s_ext if window > 0 and pos >= window else min(pos + 1, s_ext)
    return max(n, 0)


def splits(split_len, pos, s_ext, window=0):
    """The [lo, hi) ranges of the splits that run for a row at ``pos``:
    ``[s L, (s+1) L)`` within ``[0, n_keys)``; blocks past them exit."""
    n = n_keys(pos, s_ext, window)
    return [(lo, min(lo + split_len, n)) for lo in range(0, n, split_len)]


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def combine(parts):
    """(m, l, acc) partials combined in order, as the bf16 kernel combines
    its warps: the max first, then each sum and accumulator rescaled and
    added one by one."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
    l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        f = torch.exp2(m - base)
        l = l + ls * f
        acc = acc + a * f[:, None]
    return mx, l, acc


def merge(parts):
    """A row's splits merged in split order, in one pass: the running max,
    and the sum and accumulator rescaled to it split by split; o = acc /
    l, 0 where l = 0."""
    mx = torch.full_like(parts[0][0], -math.inf)
    l, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, ls, a in parts:
        mn = torch.maximum(mx, m)
        base = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
        fa, fb = torch.exp2(mx - base), torch.exp2(m - base)
        l = l * fa + ls * fb
        acc = acc * fa[:, None] + a * fb[:, None]
        mx = mn
    return acc * torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0),
                             0.0)[:, None]


def partial(q, k, v, valid, bf16: bool, split_len: int):
    """One split's (m, l, acc) for the rep rows q (rep, dh) over its keys
    k, v (n, dh) f32, ``valid`` (n,) bool."""
    rep, dh = q.shape
    scale_log2 = f32(1.0 / math.sqrt(dh)) * f32(LOG2E)
    if bf16:
        W, step = min(4, split_len // tdecode.CHUNK), tdecode.CHUNK
    else:
        W, step = 1, 64 if dh <= 128 else 32
    warps = []
    for w in range(W):
        m = torch.full((rep,), -math.inf)
        l = torch.zeros(rep)
        acc = torch.zeros(rep, dh)
        for c0 in range(w * step, k.shape[0], W * step):
            kk, vv, ok = k[c0:c0 + step], v[c0:c0 + step], valid[c0:c0 + step]
            if bf16:
                s = (q @ kk.T) * scale_log2
            else:
                s = (q * scale_log2) @ kk.T
            s = s.masked_fill(~ok[None, :], -math.inf)
            mn = torch.maximum(m, s.amax(1))
            base = torch.where(torch.isinf(mn), torch.zeros_like(mn), mn)
            al = torch.exp2(m - base)
            p = torch.exp2(s - base[:, None])
            l = l * al + p.sum(1)
            if bf16:
                p = p.to(torch.bfloat16).float()
            acc = acc * al[:, None] + p @ vv
            m = mn
        warps.append((m, l, acc))
    return combine(warps)


def emulate(q, rows_of, pos, s_ext, K, *, window=0):
    """The kernels' result for q (B, H, dh); ``rows_of(b, kvh, lo, hi)``
    gives the f32 K and V rows [lo, hi) of a row's logical cache."""
    B, H, dh = q.shape
    rep = H // K
    bf16 = q.dtype == torch.bfloat16
    split_len = tdecode.plan(K, rep, dh)
    out = torch.zeros(B, H, dh)
    for b in range(B):
        p = int(pos[b])
        for kvh in range(K):
            qr = q[b, kvh * rep:(kvh + 1) * rep].float()
            parts = []
            for lo, hi in splits(split_len, p, s_ext, window):
                k, v = rows_of(b, kvh, lo, hi)
                ok = torch.tensor([slot_valid(j, p, window)
                                   for j in range(lo, hi)])
                parts.append(partial(qr, k, v, ok, bf16, split_len))
            if parts:
                out[b, kvh * rep:(kvh + 1) * rep] = merge(parts)
    return out.to(q.dtype)


def emulate_slotted(q, kc, vc, pos, *, window=0):
    return emulate(q, lambda b, h, lo, hi: (kc[b, h, lo:hi].float(),
                                            vc[b, h, lo:hi].float()),
                   pos, kc.shape[2], kc.shape[1], window=window)


def emulate_paged(q, kp, vp, tables, pos, *, window=0):
    pt = kp.shape[2]

    def rows_of(b, h, lo, hi):
        s = torch.arange(lo, hi)
        page = tables[b].long()[s // pt]
        return kp[page, h, s % pt].float(), vp[page, h, s % pt].float()
    return emulate(q, rows_of, pos, tables.shape[1] * pt, kp.shape[1],
                   window=window)


def inputs(seed, B, H, K, dh, S_max, dtype):
    rng = np.random.default_rng(seed)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(dtype) for s in ((B, H, dh), (B, K, S_max, dh),
                                      (B, K, S_max, dh)))
    return q, kc, vc


def to_pages(kc, vc, pos, pt, seed):
    """The slotted caches as shuffled page pools; table entries past a
    row's pages name the scratch page (the last, zeros)."""
    B, K, S_max, dh = kc.shape
    NP = S_max // pt
    P = B * NP + 1
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(P - 1))
    tables = torch.full((B, NP), P - 1, dtype=torch.int32)
    kp = torch.zeros((P, K, pt, dh), dtype=kc.dtype)
    vp = torch.zeros_like(kp)
    for b, x in enumerate(pos):
        for i in range(min(int(x) // pt + 1, NP)):
            page = int(perm[b * NP + i])
            tables[b, i] = page
            kp[page] = kc[b, :, i * pt:(i + 1) * pt]
            vp[page] = vc[b, :, i * pt:(i + 1) * pt]
    return kp, vp, tables


def test_plan_depends_on_head_geometry_only():
    assert list(inspect.signature(tdecode.plan).parameters) == \
        ["K", "rep", "dh"]
    for K, rep, dh in GEOMETRIES:
        L = tdecode.plan(K, rep, dh)
        assert L == tdecode.plan(K, rep, dh)
        assert L % tdecode.CHUNK == 0
        assert tdecode.CHUNK <= L <= tdecode.MAX_SPLIT
        assert rep <= tdecode.max_rep(dh)


@pytest.mark.parametrize("window", [0, 128])
def test_splits_cover_every_valid_key_once(window):
    for L in (16, 32, 64, 128):
        for S_max in ((128,) if window else (256, 512)):
            cases = ((0, L - 1, L, S_max - 1) if not window else
                     (0, L - 1, L, S_max - 1, S_max, 300, 1000))
            for pos in cases:
                got = splits(L, pos, S_max, window)
                n = n_keys(pos, S_max, window)
                # fixed boundaries, in order, each key once
                assert [lo for lo, _ in got] == list(range(0, n, L))
                keys = [j for lo, hi in got for j in range(lo, hi)]
                assert keys == list(range(n))
                valid = [j for j in range(S_max)
                         if slot_valid(j, pos, window)]
                assert set(valid) <= set(keys), (L, S_max, pos)
                if window and pos >= S_max:      # wrapped: the whole ring
                    assert keys == list(range(S_max))


@pytest.mark.parametrize("dh,H,K,S_max,pos,window,dtype", [
    (64, 15, 5, 256, (0, 37, 159, 255), 0, torch.bfloat16),
    (256, 10, 1, 256, (5, 64, 159, 255), 0, torch.bfloat16),
    (64, 15, 5, 128, (5, 127, 300, 1000), 128, torch.bfloat16),
    (256, 8, 2, 64, (5, 63, 100, 300), 64, torch.bfloat16),
    (64, 15, 5, 256, (0, 37, 159, 255), 0, torch.float32),
    (256, 8, 2, 64, (5, 63, 100, 300), 64, torch.float32)])
def test_emulation_vs_plain_and_jax(dh, H, K, S_max, pos, window, dtype):
    q, kc, vc = inputs(dh + S_max + window, len(pos), H, K, dh, S_max, dtype)
    p = torch.tensor(pos, dtype=torch.int32)
    got = emulate_slotted(q, kc, vc, p, window=window).float()
    tol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    want = tdecode.plain(q, kc, vc, p, window=window).float()
    assert (got - want).abs().max().item() <= tol
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (q, kc, vc))
    jwant = np.asarray(jref.decode_attention(
        jq, jk, jv, jnp.asarray(np.asarray(pos, np.int32)),
        window=window).astype(jnp.float32))
    assert np.abs(got.numpy() - jwant).max() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulation_rows_independent_of_batch_and_cache_len(dtype):
    """A row's bits do not depend on the batch it is decoded in nor on the
    cache length beyond its valid rows (the scheduler at B = 4 against
    reference_generate at B = 1, cache_len 256 against 512)."""
    pos = (5, 64, 159, 255)
    p = torch.tensor(pos, dtype=torch.int32)
    for H, K, dh in ((15, 5, 64), (10, 1, 256)):
        q, kl, vl = inputs(dh, 4, H, K, dh, 512, dtype)
        kc, vc = kl[:, :, :256], vl[:, :, :256]
        full = emulate_slotted(q, kc, vc, p)
        assert torch.equal(full, emulate_slotted(q, kl, vl, p))
        for i in range(4):
            assert torch.equal(full[i:i + 1], emulate_slotted(
                q[i:i + 1], kc[i:i + 1], vc[i:i + 1], p[i:i + 1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_emulation_paged_equals_slotted(dtype):
    """Splits sit at logical positions, so the paged result equals the
    slotted one over the same rows, whatever the pages' order."""
    pos = (37, 80, 123, 159)
    p = torch.tensor(pos, dtype=torch.int32)
    for H, K, dh in ((15, 5, 64), (10, 1, 256)):
        q, kc, vc = inputs(dh + 1, 4, H, K, dh, 256, dtype)
        kp, vp, tb = to_pages(kc, vc, pos, 16, dh)
        slotted = emulate_slotted(q, kc, vc, p)
        assert torch.equal(emulate_paged(q, kp, vp, tb, p), slotted)
        tol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
        want = tdecode.plain_paged(q, kp, vp, tb, p).float()
        assert (slotted.float() - want).abs().max().item() <= tol


def test_masked_split_merges_to_the_right_answer():
    """A split whose every key is masked writes m = -inf, l = 0 and a zero
    accumulator; merged anywhere in the order it changes nothing, and a
    head with only such splits gets 0."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((96, 64)).astype(np.float32))
            for _ in range(2))
    for bf16 in (True, False):
        qq = q.to(torch.bfloat16).float() if bf16 else q
        parts = [partial(qq, k[lo:lo + 32], v[lo:lo + 32],
                         torch.ones(32, dtype=torch.bool), bf16, 32)
                 for lo in (0, 32, 64)]
        masked = partial(qq, k[:32], v[:32], torch.zeros(32, dtype=torch.bool),
                         bf16, 32)
        m, l, acc = masked
        assert torch.isinf(m).all() and (m < 0).all()
        assert not l.any() and not acc.any()
        want = merge(parts)
        for at in range(4):
            assert torch.equal(merge(parts[:at] + [masked] + parts[at:]),
                               want)
        assert not merge([masked, masked]).any()
        # and the merged splits are the softmax over all 96 keys
        s = (qq @ k.T) / math.sqrt(64)
        full = torch.softmax(s, -1)
        if bf16:
            full = full.to(torch.bfloat16).float()
        tol = BF16_ATOL if bf16 else F32_ATOL
        assert (want - full @ v).abs().max().item() <= tol
