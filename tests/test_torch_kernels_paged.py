"""The port's paged decode attention and the paged side of the dense LM,
against the JAX package's oracles on the same numpy inputs (f32,
``REPRO_PALLAS=ref``): ``ref.decode_attention_paged`` over ragged tables
that point past ``pos`` into the scratch page; the in-place B-row
scatter of ``attention_decode_paged``; ``gather_pages`` / ``pack_pages``
round trips; ``prefill_continue`` after gathered pages against a full
``prefill``; ``decode_step_paged`` against ``decode_step``.  The CUDA
kernel is held against its plain version by ``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from torch_testlib import close, rand

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def paged_inputs(rng, B, H, K, dh, pt, NP, pos):
    """A shuffled pool of B * NP pages plus the scratch page; each row's
    table holds its own pages up to ``pos // pt``, then scratch."""
    P = B * NP + 1
    perm = rng.permutation(P - 1)
    tables = np.full((B, NP), P - 1, np.int32)
    for b, p in enumerate(pos):
        n = p // pt + 1
        tables[b, :n] = perm[b * NP:b * NP + n]
    return (rand(rng, B, H, dh), rand(rng, P, K, pt, dh),
            rand(rng, P, K, pt, dh), tables, np.asarray(pos, np.int32))


@pytest.mark.parametrize("B,H,K,dh,pt,NP,pos", [
    (4, 15, 5, 64, 16, 16, (37, 80, 123, 159)),    # smollm heads, rep 3
    (3, 8, 2, 20, 7, 5, (0, 6, 34)),               # pt not a tile size
    (2, 4, 4, 16, 4, 3, (11, 3)),                  # rep 1
])
def test_paged_oracle_matches_jax(B, H, K, dh, pt, NP, pos):
    rng = np.random.default_rng(B * pt)
    q, kp, vp, tables, p = paged_inputs(rng, B, H, K, dh, pt, NP, pos)
    want = jref.decode_attention_paged(*map(jnp.asarray,
                                            (q, kp, vp, tables, p)))
    args = tuple(map(torch.from_numpy, (q, kp, vp, tables, p)))
    close(tref.decode_attention_paged(*args), want)
    close(tdecode.plain_paged(*args), want)
    close(tops.decode_attention_paged(*args),
          jops.decode_attention_paged(*map(jnp.asarray,
                                           (q, kp, vp, tables, p))))


def test_paged_equals_slotted_over_the_gathered_cache():
    rng = np.random.default_rng(3)
    B, H, K, dh, pt, NP = 3, 6, 2, 32, 8, 4
    q, kp, vp, tables, p = map(torch.from_numpy, paged_inputs(
        rng, B, H, K, dh, pt, NP, (5, 17, 31)))
    kc = kp[tables.long()].transpose(1, 2).reshape(B, K, NP * pt, dh)
    vc = vp[tables.long()].transpose(1, 2).reshape(B, K, NP * pt, dh)
    torch.testing.assert_close(tdecode.plain_paged(q, kp, vp, tables, p),
                               tdecode.plain(q, kc, vc, p), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the paged side of the dense LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


def test_attention_decode_paged_scatters_rows_in_place(pair):
    _, _, tm, tparams = pair
    from repro_torch.models import layers
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    P, pt = 5, 4
    kp = torch.zeros((P, cfg.n_kv_heads, pt, cfg.dh))
    vp = torch.zeros_like(kp)
    tables = torch.tensor([[2, 0], [4, 4], [4, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 0, 3], dtype=torch.int32)   # rows 1, 2 inactive
    x = torch.from_numpy(rand(rng, 3, 1, cfg.d_model))
    p = ttransformer._index(tparams["blocks"]["s0"], 0)["attn"]
    _, k2, v2 = layers.attention_decode_paged(cfg, p, x, pos, kp, vp, tables)
    assert k2 is kp and v2 is vp                        # written in place
    _, k, _ = layers.qkv_project(cfg, p, x, pos[:, None])
    torch.testing.assert_close(kp[0, :, 1], k[0, 0])    # page 0, row 5 % 4
    written = (kp.abs().sum(dim=(1, 3)) > 0).nonzero().tolist()
    assert sorted(map(tuple, written)) == [(0, 1), (4, 0), (4, 3)]


def test_pack_then_gather_round_trip(pair):
    _, _, tm, _ = pair
    rng = np.random.default_rng(5)
    pt = 4
    pools = tm.init_kv_pages(7, pt)
    cache = tm.init_request_cache(3 * pt, 64)
    for n in ("k", "v"):
        cache["s0"][n].copy_(torch.from_numpy(rand(
            rng, *cache["s0"][n].shape)))
    ids = torch.tensor([5, 1, 3], dtype=torch.int32)
    tm.pack_pages(pools, cache, ids, 0)
    back = tm.gather_pages(tm.init_request_cache(3 * pt, 64), pools, ids)
    for n in ("k", "v"):
        assert torch.equal(back["s0"][n], cache["s0"][n])
        assert torch.equal(pools["s0"][n][:, 3],
                           cache["s0"][n][:, 0, :, 2 * pt:3 * pt])
    tm.copy_page(pools, 3, 6)
    assert torch.equal(pools["s0"]["k"][:, 6], pools["s0"]["k"][:, 3])


def test_prefill_continue_after_gathered_pages_equals_prefill(pair):
    jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(6)
    pt, S, off = 8, 21, 16
    tok = rng.integers(0, tm.cfg.vocab_size, (1, S))
    full, want_cache = tm.prefill(tparams, {"tokens": torch.as_tensor(tok)},
                                  tm.init_cache(1, 32))
    # the first two pages go through a pool, the suffix is prefilled
    pools = tm.init_kv_pages(4, pt)
    ids = torch.tensor([2, 0], dtype=torch.int32)
    tm.pack_pages(pools, want_cache, ids, 0)
    cache = tm.gather_pages(tm.init_request_cache(32, 32), pools, ids)
    logits, cache = tm.prefill_continue(
        tparams, {"tokens": torch.as_tensor(tok[:, off:])}, cache, off=off)
    close(logits, full[:, off:], **TOL)
    for n in ("k", "v"):
        close(cache["s0"][n][:, :, :, :S], want_cache["s0"][n][:, :, :, :S],
              **TOL)
    jcache = jm.init_cache(1, 32)
    jcache = jax.tree.map(lambda a, t: jnp.asarray(t.numpy()), jcache,
                          {"s0": {n: cache["s0"][n] for n in ("k", "v")}})
    jl, _ = jm.prefill_continue(jparams, {"tokens": jnp.asarray(
        tok[:, off:], jnp.int32)}, jcache, off=off)
    close(logits, jl, **TOL)


def test_decode_step_paged_equals_decode_step(pair):
    _, _, tm, tparams = pair
    rng = np.random.default_rng(7)
    pt, B, S = 8, 2, 13
    tok = rng.integers(0, tm.cfg.vocab_size, (B, S))
    slot_cache = tm.init_cache(B, 4 * pt)
    tm.prefill(tparams, {"tokens": torch.as_tensor(tok)}, slot_cache)
    pools = tm.init_kv_pages(2 * 4 + 1, pt)
    tables = torch.tensor([[3, 6, 8, 8], [0, 7, 8, 8]], dtype=torch.int32)
    for b in range(B):
        one = {"s0": {n: slot_cache["s0"][n][:, b:b + 1] for n in ("k", "v")}}
        tm.pack_pages(pools, one, tables[b, :2], 0)
    nxt = torch.as_tensor(rng.integers(0, tm.cfg.vocab_size, (B, 1)))
    pos = torch.full((B,), S, dtype=torch.int32)
    want, _ = tm.decode_step(tparams, slot_cache, nxt, pos)
    got, cache, _ = tm.decode_step_paged(tparams, tm.init_cache_paged(B, 32),
                                         pools, tables, nxt, pos)
    assert cache == {"s0": {"k": None, "v": None}}
    close(got, want, **TOL)
