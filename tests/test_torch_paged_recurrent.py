"""Paged decode of the recurrent families on the CPU (f32, smoke configs,
weights carried from the JAX init, ``REPRO_PALLAS=ref``): the paged state
is built over every cache group, as the reference builds it.  The
full-attention groups page, stacked ``(n_units, P, K, pt, dh)`` or in the
tail ``(P, K, pt, dh)``, and the SSM and RG-LRU states stay slot-resident
beside them.  Held leaf by leaf against the reference's structures, and
with the page moves against the reference's, for mamba2-780m (nothing
pages), recurrentgemma-2b (its ``attn`` slot pages, a two-layer rglru tail)
and a Griffin variant whose tail holds an ``attn`` layer.  The paged
scheduler's tokens equal the port's ``reference_generate`` and JAX's
greedy ones; a model with slot-resident state keeps the slotted length
ceiling; a pool of zero-byte pages admits and releases."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving.decode import reference_generate as jreference_generate
from repro_torch import tree as tree_util
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (CacheOverflowError, DecodeScheduler,
                                 GenerateSpec, KVPagePool,
                                 reference_generate)

torch.set_num_threads(2)
CACHE_LEN = 48
PT = 16
# (arch, config overrides): the tail-attn variant has pattern ("attn",
# "rglru", "rglru"), one unit and the tail ("attn", "rglru")
CASES = {"mamba2": ("mamba2-780m", {}),
         "recurrentgemma": ("recurrentgemma-2b", {}),
         "griffin-tail-attn": ("recurrentgemma-2b", dict(
             block_pattern=("attn", "rglru", "rglru"), n_layers=5))}
# kv_page_bytes(16) of the reference at f32: one paged layer of K=1, dh=16
# is 2 x 16 x 16 x 4 bytes
PAGE_BYTES = {"mamba2": 0, "recurrentgemma": 2048,
              "griffin-tail-attn": 4096}


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module", params=sorted(CASES))
def fam(request):
    arch, over = CASES[request.param]
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32, **over)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return request.param, tm, tparams, jm, jparams


def _jshapes(tree):
    """{path: shape or None} of a JAX tree, ``None`` leaves kept."""
    return {"/".join(str(getattr(k, "key", k)) for k in p):
            None if leaf is None else tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: x is None)[0]}


def _tshapes(tree):
    return {"/".join(p): None if leaf is None else tuple(leaf.shape)
            for p, leaf in tree_util.leaves_with_path(tree)}


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n,))


def _concurrent(sched, specs):
    out = [None] * len(specs)

    def run(i):
        out[i] = sched.generate(specs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_paged_state_structure_equals_reference(fam):
    """kv_page_bytes, the paged kinds, and the ``None`` map and shapes of
    the pools, the slot-resident state and a request's prefill cache (and
    that cache stripped), leaf by leaf against the reference's."""
    case, tm, _, jm, _ = fam
    assert tm.kv_page_bytes(PT) == jm.kv_page_bytes(PT) == PAGE_BYTES[case]
    assert tm.paged_kinds() == sorted(jm.paged_kinds())
    assert tm.supports_prefix_cache is jm.supports_prefix_cache is False
    pairs = [(tm.init_kv_pages(9, PT), jm.init_kv_pages(9, PT)),
             (tm.init_cache_paged(3, CACHE_LEN),
              jm.init_cache_paged(3, CACHE_LEN)),
             (tm.init_request_cache(2 * PT, CACHE_LEN),
              jm.init_request_cache(2 * PT, CACHE_LEN)),
             (tm.strip_paged(tm.init_request_cache(2 * PT, CACHE_LEN)),
              jm.strip_paged(jm.init_request_cache(2 * PT, CACHE_LEN)))]
    for got, want in pairs:
        assert _tshapes(got) == _jshapes(want)
    pools = tm.init_kv_pages(9, PT)
    assert [k for k, v in pools.items() if v is not None] == \
        {"mamba2": [], "recurrentgemma": ["s2"],
         "griffin-tail-attn": ["s0", "t0"]}[case]


def test_page_moves_equal_reference(fam):
    """pack_pages, copy_page and gather_pages move the same values as the
    reference's in stacked and tail groups: a request cache of random
    values packed into shuffled pages, one page forked, the pages gathered
    back into a fresh cache."""
    _, tm, _, jm, _ = fam
    rng = np.random.default_rng(3)
    one = tm.init_request_cache(3 * PT, CACHE_LEN)
    for leaf in tree_util.leaves(one):
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    jone = jax.tree.map(jnp.asarray, tree_util.tree_map(
        lambda t: t.numpy(), one))
    ids = np.array([6, 2, 4], np.int32)
    tpools = tm.pack_pages(tm.init_kv_pages(9, PT), one,
                           torch.as_tensor(ids[1:]), 1)
    jpools = jm.pack_pages(jm.init_kv_pages(9, PT), jone,
                           jnp.asarray(ids[1:]), 1)
    tpools = tm.copy_page(tpools, 2, 7)
    jpools = jm.copy_page(jpools, 2, 7)
    tpools = tm.pack_pages(tpools, one, torch.as_tensor(ids[:1]), 0)
    jpools = jm.pack_pages(jpools, jone, jnp.asarray(ids[:1]), 0)
    got = tm.gather_pages(tm.init_request_cache(3 * PT, CACHE_LEN), tpools,
                          torch.as_tensor(ids))
    want = jm.gather_pages(jm.init_request_cache(3 * PT, CACHE_LEN), jpools,
                           jnp.asarray(ids))
    for tree_t, tree_j in ((tpools, jpools), (got, want)):
        flat_j = {"/".join(str(getattr(k, "key", k)) for k in p): leaf
                  for p, leaf in jax.tree_util.tree_flatten_with_path(
                      tree_j)[0]}
        flat_t = {"/".join(p): leaf
                  for p, leaf in tree_util.leaves_with_path(tree_t)
                  if leaf is not None}
        assert sorted(flat_t) == sorted(flat_j)
        for k, leaf in flat_t.items():
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(flat_j[k]), err_msg=k)


def test_paged_scheduler_equals_reference(fam):
    """Three concurrent mixed-length prompts, one at temperature 0.5:
    every token equals the port's ``reference_generate``, the greedy ones
    the JAX package's, and no page stays pinned."""
    _, tm, params, jm, jparams = fam
    cfg = tm.cfg
    sched = DecodeScheduler(tm, params, n_slots=3, cache_len=CACHE_LEN,
                            kv_page_tokens=PT)
    assert sched.n_pages == 3 * (CACHE_LEN // PT)
    prompts = [_prompt(cfg, 50 + i, n) for i, n in enumerate((5, 17, 30))]
    specs = [GenerateSpec(prompt=p, n_new=7, seed=i,
                          temperature=0.5 if i == 1 else 0.0)
             for i, p in enumerate(prompts)]
    got = _concurrent(sched, specs)
    for p, s, r in zip(prompts, specs, got):
        assert r.tokens == reference_generate(
            tm, params, p, n_new=7, seed=s.seed, temperature=s.temperature,
            cache_len=CACHE_LEN, device="cpu")
        if s.temperature == 0.0:
            assert r.tokens == jreference_generate(
                jm, jparams, p.astype(np.int32), n_new=7,
                cache_len=CACHE_LEN)
    st = sched.stats()
    assert st["kv_pages_pinned"] == 0 and st["active"] == 0
    assert st["kv_prefix_hits"] == 0
    sched.kvpool.check_invariants()


def test_slot_resident_state_keeps_the_slotted_ceiling(fam):
    """With any slot-resident kind the paged scheduler keeps
    ``cache_len`` as the length ceiling, however many pages a request
    could hold (the reference's ``_all_paged``)."""
    _, tm, params, _, _ = fam
    sched = DecodeScheduler(tm, params, n_slots=2, cache_len=32,
                            kv_page_tokens=8, kv_max_seq=64)
    assert not sched._all_paged
    with pytest.raises(CacheOverflowError):
        sched.generate(GenerateSpec(prompt=_prompt(tm.cfg, 1, 30), n_new=8))
    assert sched.kvpool.stats().used == 0


def test_zero_byte_pages_admit_and_release():
    """A pool of ``page_bytes=0`` (a model that pages nothing) admits,
    releases and keeps its invariants, as the byte-sized one does."""
    pool = KVPagePool(n_pages=6, page_tokens=PT, page_bytes=0,
                      model_key="m")
    a = pool.alloc(4)
    b = pool.alloc(2, timeout=1.0)
    assert pool.stats().used == 6
    pool.check_invariants()
    pool.release(a)
    c = pool.alloc(3)
    pool.release(b)
    pool.release(c)
    st = pool.stats()
    assert st.used == 0 and st.pinned == 0
    pool.check_invariants()
