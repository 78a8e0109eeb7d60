"""The attention kernels at any head dim.  ``flash_attention.padded_dim``
maps a head dim to the instance it runs in (32, 64, 128 or 256): the
kernels read rows of the true dh, zero-fill the rest of the instance's
width on chip, mask their stores past dh, and scale scores by 1/sqrt(dh)
of the true dh.  That arithmetic, emulated on the CPU (q, k, v and the
caches zero-padded to the instance's width, attention at the true scale,
the output cut back to dh), is held against the port's plain versions at
the true dh and the JAX package's oracle (``repro.kernels.ref`` under
``REPRO_PALLAS=ref``) within 1e-5, at dh 8, 20, 80 and 120: flash
attention causal, windowed and bidirectional; decode over a slotted cache
and over a ring (a window); decode over pages.  The plans and the rep
limit cover every assigned config.  ``chip_smoke.py`` phase 3 holds the
CUDA kernels to the plain versions at dh 20, 80 and 120 on the card."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models.api import get_config

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
DIMS = [8, 20, 80, 120]
ASSIGNED = ["yi-9b", "codeqwen1.5-7b", "h2o-danube-3-4b", "smollm-360m",
            "hubert-xlarge", "mixtral-8x7b", "arctic-480b", "internvl2-76b",
            "recurrentgemma-2b"]


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def pad(x, dp):
    return F.pad(x, (0, dp - x.shape[-1]))


def attend(q, k, v, scale, valid):
    """softmax(q k^T scale) v over the keys ``valid`` (broadcast to the
    scores), f32; a row with no key gives 0.  q (..., S, dp), k/v (..., T,
    dp)."""
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return (p @ v) / torch.where(l == 0, torch.ones_like(l), l)


def flash_padded(q, k, v, causal, window):
    """The kernel's arithmetic: q (B, S, H, dh), k/v (B, T, K, dh) read
    into the padded width, scale of the true dh, output cut to dh."""
    B, S, H, dh = q.shape
    T, K = k.shape[1], k.shape[2]
    dp = tflash.padded_dim(dh)
    qp = pad(q, dp).transpose(1, 2)
    kp = pad(k, dp).transpose(1, 2).repeat_interleave(H // K, dim=1)
    vp = pad(v, dp).transpose(1, 2).repeat_interleave(H // K, dim=1)
    qpos = (T - S) + torch.arange(S)[:, None]
    kpos = torch.arange(T)[None, :]
    if causal:
        valid = kpos <= qpos
        if window > 0:
            valid = valid & (kpos > qpos - window)
    elif window > 0:
        valid = (kpos - qpos).abs() < window
    else:
        valid = torch.ones((S, T), dtype=torch.bool)
    o = attend(qp, kp, vp, 1.0 / math.sqrt(dh), valid)
    assert bool((o[..., dh:] == 0).all())       # padding columns stay 0
    return o[..., :dh].transpose(1, 2)


def decode_padded(q, kc, vc, pos, window):
    """The decode kernels' arithmetic over a slotted cache (B, K, S_max,
    dh) zero-padded on chip to the instance's width."""
    B, H, dh = q.shape
    K, s_max = kc.shape[1], kc.shape[2]
    dp = tflash.padded_dim(dh)
    rep = H // K
    qp = pad(q, dp).reshape(B, K, rep, 1, dp)
    kp, vp = pad(kc, dp)[:, :, None], pad(vc, dp)[:, :, None]
    j = torch.arange(s_max)[None, :]
    cur = pos.long()[:, None]
    if window > 0:
        held = cur - torch.remainder(cur - j, window)
        valid = (held >= 0) & (held > cur - window)
    else:
        valid = j <= cur
    o = attend(qp, kp, vp, 1.0 / math.sqrt(dh),
               valid[:, None, None, None, :])
    return o[..., 0, :dh].reshape(B, H, dh)


def test_padded_dim_maps_every_head_dim_to_an_instance():
    for dh in range(1, 257):
        dp = tflash.padded_dim(dh)
        assert dp in tflash.HEAD_DIMS and dh <= dp
        assert dp == 32 or dh > dp // 2
    for dh in (64, 128, 256):
        assert tflash.padded_dim(dh) == dh      # the instances they had
    with pytest.raises(ValueError):
        tflash.padded_dim(257)


def test_every_assigned_config_has_an_instance():
    """Each config's heads fit an instance: a padded dh, a rep within
    ``max_rep``, a split length the kernels take and the flash key tile of
    its instance; full and smoke (dh 8, 16, 20) alike."""
    for arch, smoke in ((a, s) for a in ASSIGNED for s in (False, True)):
        cfg = get_config(arch, smoke=smoke)
        dh, K = cfg.dh, cfg.n_kv_heads
        rep = cfg.n_heads // K
        dp = tflash.padded_dim(dh)
        assert rep <= tdecode.max_rep(dh), (arch, smoke, rep, dh)
        L = tdecode.plan(K, rep, dh)
        assert L % tdecode.CHUNK == 0 and L <= tdecode.MAX_SPLIT
        assert L == tdecode.plan(K, rep, dp)     # the instance decides
        p = tflash.plan(1, 128, cfg.n_heads, K, dh)
        assert p.key_tile == tflash.KEY_TILE[dp]


@pytest.mark.parametrize("dh", DIMS)
def test_flash_padded_matches_true_dh(dh):
    rng = np.random.default_rng(dh)
    for B, S, T, H, K, causal, win in ((2, 19, 19, 8, 2, True, 0),
                                       (1, 24, 24, 4, 4, True, 7),
                                       (1, 9, 30, 6, 2, True, 0),
                                       (2, 13, 13, 4, 1, False, 5)):
        q, k, v = (randn(rng, B, n, h, dh)
                   for n, h in ((S, H), (T, K), (T, K)))
        got = flash_padded(q, k, v, causal, win)
        torch.testing.assert_close(
            got, tflash.plain(q, k, v, causal=causal, window=win), **TOL)
        want = jref.mha_attention(*(jnp.asarray(x.transpose(1, 2).numpy())
                                    for x in (q, k, v)),
                                  causal=causal, window=win)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("dh", DIMS)
def test_decode_padded_matches_true_dh(dh):
    """Slotted, at positions inside a 48-slot cache, and a 16-slot ring
    under a window of 16 (positions past it wrap)."""
    rng = np.random.default_rng(100 + dh)
    for H, K, s_max, pos, win in ((8, 2, 48, (0, 7, 30, 47), 0),
                                  (4, 4, 16, (3, 15, 16, 40), 16)):
        B = len(pos)
        q = randn(rng, B, H, dh)
        kc, vc = randn(rng, B, K, s_max, dh), randn(rng, B, K, s_max, dh)
        p = torch.tensor(pos, dtype=torch.int32)
        got = decode_padded(q, kc, vc, p, win)
        torch.testing.assert_close(
            got, tdecode.plain(q, kc, vc, p, window=win), **TOL)
        want = jref.decode_attention(
            *(jnp.asarray(x.numpy()) for x in (q, kc, vc, p)), window=win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dh", DIMS)
def test_paged_padded_matches_true_dh(dh):
    """Pages of 8 positions, tables naming shuffled pages, entries past a
    row's pages on a scratch page: the padded arithmetic over the rows
    the tables gather equals the plain paged version and JAX's."""
    rng = np.random.default_rng(200 + dh)
    B, H, K, pt, NP = 3, 8, 2, 8, 4
    pos = (5, 17, 31)
    P = B * NP + 1
    kp, vp = randn(rng, P, K, pt, dh), randn(rng, P, K, pt, dh)
    perm = rng.permutation(B * NP)
    tables = np.full((B, NP), P - 1, np.int32)
    for b, x in enumerate(pos):
        n = x // pt + 1
        tables[b, :n] = perm[b * NP:b * NP + n]
    tb = torch.from_numpy(tables)
    q = randn(rng, B, H, dh)
    p = torch.tensor(pos, dtype=torch.int32)
    kc = kp[tb.long()].transpose(1, 2).reshape(B, K, NP * pt, dh)
    vc = vp[tb.long()].transpose(1, 2).reshape(B, K, NP * pt, dh)
    got = decode_padded(q, kc, vc, p, 0)
    torch.testing.assert_close(
        got, tdecode.plain_paged(q, kp, vp, tb, p), **TOL)
    want = jref.decode_attention_paged(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, tb, p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
