"""The port's paged KV: the ``KVPagePool`` (refcounts, backpressure,
prefix index and LRU, copy-on-write) held to the cases of
``tests/test_paged_kv.py`` and to the JAX pool itself (same operations,
same ids and stats; same page hashes), and the paged ``DecodeScheduler``
on the CPU (smollm-360m smoke, f32): tokens equal to
``reference_generate``, to the slotted scheduler's and to the JAX paged
scheduler's; shared prefixes pin the same physical pages."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro.serving import kvpages as jkv
from repro_torch.metrics import MetricsRegistry
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (CacheOverflowError, DecodeScheduler,
                                 GenerateSpec, KVPagePool, page_hashes,
                                 paged_page_count, reference_generate,
                                 validate_spec_paged)

torch.set_num_threads(2)
CACHE_LEN = 64
PT = 16


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module")
def dense():
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return tcfg, tm, tparams, jm, jparams


def _prompt(cfg, seed, n=8):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n,))


def _ref(m, params, prompt, **kw):
    return reference_generate(m, params, prompt, cache_len=CACHE_LEN,
                              device="cpu", **kw)


def _paged(m, params, **kw):
    return DecodeScheduler(m, params, n_slots=kw.pop("n_slots", 2),
                           cache_len=kw.pop("cache_len", CACHE_LEN),
                           kv_page_tokens=kw.pop("kv_page_tokens", PT),
                           kv_max_seq=kw.pop("kv_max_seq", CACHE_LEN), **kw)


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


# ---------------------------------------------------------------------------
# page hashes and the pool
# ---------------------------------------------------------------------------

def test_page_hashes_running_partial_and_equal_to_jax():
    toks = np.arange(40, dtype=np.int64)
    hs = page_hashes("m", toks, 16)
    assert len(hs) == 2                    # trailing partial page unhashed
    assert page_hashes("m", toks[:32], 16) == hs
    other = toks.copy()
    other[0] = 999
    assert page_hashes("m", other, 16)[1] != hs[1]
    assert page_hashes("other", toks, 16) != hs
    assert hs == jkv.page_hashes("m", toks.astype(np.int32), 16)


def test_pool_alloc_release_refcount():
    pool = KVPagePool(n_pages=4, page_tokens=8)
    ids = pool.alloc(3)
    assert len(ids) == 3 and len(set(ids)) == 3
    st = pool.stats()
    assert (st.pinned, st.free) == (3, 1)
    pool.release(ids[:1])
    assert pool.stats().free == 2
    pool.release(ids[1:])
    st = pool.stats()
    assert (st.pinned, st.free, st.used) == (0, 4, 0)
    pool.check_invariants()


def test_pool_never_fits_is_error_smaller_is_backpressure():
    pool = KVPagePool(n_pages=2, page_tokens=8)
    with pytest.raises(CacheOverflowError):
        pool.alloc(3)
    held = pool.alloc(2)
    with pytest.raises(TimeoutError):
        pool.alloc(1, timeout=0.05)
    got = []
    t = threading.Thread(target=lambda: got.extend(pool.alloc(2)))
    t.start()
    time.sleep(0.05)
    assert not got                         # still blocked
    pool.release(held)
    t.join(timeout=5)
    assert len(got) == 2
    pool.check_invariants()


def test_pool_prefix_lru_and_cow_match_jax_pool():
    """One sequence of register / release / match / evict / fork on both
    pools gives the same page ids and the same stats at every step."""
    hs = page_hashes("m", np.arange(8), 4)
    seen = []
    for mod in (jkv, None):
        pool = (mod.KVPagePool if mod else KVPagePool)(n_pages=3,
                                                       page_tokens=4)
        log = []
        ids = pool.alloc(2)
        for pid, h in zip(ids, hs):
            pool.register(pid, h)
        pool.release(ids)                  # registered -> cached, not free
        log.append((ids, pool.stats()))
        hit = pool.match_prefix(hs)        # revived in order, pinned
        log.append((hit, pool.stats()))
        log.append((pool.match_prefix(["nope"]), pool.stats()))
        hit2 = pool.match_prefix(hs[:1])   # page 0 now shared
        fork = pool.ensure_writable(hit[0])
        log.append((list(fork), pool.stats()))
        pool.release([fork[0]] + hit2 + hit[1:])
        big = pool.alloc(3)                # pressure evicts cached LRU
        log.append((big, pool.match_prefix(hs), pool.stats()))
        pool.release(big)
        pool.check_invariants()
        seen.append([tuple(dataclasses.astuple(x)
                           if dataclasses.is_dataclass(x) else x
                           for x in entry) for entry in log])
    assert seen[0] == seen[1]
    assert seen[1][3][0][1] is True        # the shared page was forked


def test_pool_storm_invariants():
    pool = KVPagePool(n_pages=16, page_tokens=4)
    hs = page_hashes("m", np.arange(64), 4)
    stop = threading.Event()
    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                try:
                    ids = pool.alloc(int(r.integers(1, 4)), timeout=0.2)
                except TimeoutError:
                    continue
                if r.random() < 0.5:
                    for pid in ids:
                        pool.register(pid, hs[int(r.integers(len(hs)))])
                hit = pool.match_prefix(hs[:int(r.integers(1, 4))])
                pool.check_invariants()
                pool.release(hit)
                pool.release(ids)
                pool.check_invariants()
        except BaseException as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors
    pool.check_invariants()


def test_validate_spec_paged_and_page_count(dense):
    _, m, _, jm, _ = dense
    spec = GenerateSpec(prompt=[1, 2, 3], n_new=100)
    with pytest.raises(CacheOverflowError, match="4 pages x 8 tokens"):
        validate_spec_paged(spec, 3, page_tokens=8, n_pages=4)
    pool = KVPagePool(n_pages=4, page_tokens=8)
    held = pool.alloc(3)
    with pytest.raises(CacheOverflowError, match="live occupancy 3/4 pages"):
        validate_spec_paged(spec, 3, page_tokens=8, n_pages=4,
                            stats=pool.stats())
    pool.release(held)
    assert validate_spec_paged(GenerateSpec(prompt=[1], n_new=8), 1,
                               page_tokens=8, n_pages=4) == 8
    per = m.kv_page_bytes(PT)
    assert per == jm.kv_page_bytes(PT) > 0
    assert paged_page_count(m, page_tokens=PT,
                            budget_bytes=10 * per + 3) == 10
    assert paged_page_count(m, page_tokens=PT, n_slots=4,
                            cache_len=CACHE_LEN) == 4 * (CACHE_LEN // PT)
    with pytest.raises(ValueError):
        paged_page_count(m, page_tokens=PT, budget_bytes=per - 1)


# ---------------------------------------------------------------------------
# the paged scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-3-4b"])
def test_paged_scheduler_equals_reference(arch):
    """Concurrent mixed-length paged generation equals the serial
    reference (h2o-danube's sliding window keeps its ring cache
    slot-resident under the paged scheduler)."""
    cfg = dataclasses.replace(tget_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    m = ttransformer.build(cfg, device="cpu")
    params = m.init(0)
    sched = _paged(m, params, n_slots=3)
    assert sched.model.supports_prefix_cache == (arch == "smollm-360m")
    prompts = [_prompt(cfg, i, n) for i, n in enumerate((5, 8, 19))]
    specs = [GenerateSpec(prompt=p, n_new=7, seed=i,
                          temperature=0.5 if i == 2 else 0.0)
             for i, p in enumerate(prompts)]
    for p, s, r in zip(prompts, specs, _concurrent(sched, specs)):
        assert r.tokens == _ref(m, params, p, n_new=7, seed=s.seed,
                                temperature=s.temperature)
    assert sched.kvpool.stats().pinned == 0
    sched.kvpool.check_invariants()


def test_paged_tokens_equal_slotted_and_jax_paged(dense):
    cfg, m, params, jm, jparams = dense
    shared = _prompt(cfg, 60, n=2 * PT)
    prompts = [np.concatenate([shared, _prompt(cfg, 61 + i, n)])
               for i, n in enumerate((3, 9, 17))]
    slotted = DecodeScheduler(m, params, n_slots=3, cache_len=CACHE_LEN)
    want = [slotted.generate(GenerateSpec(prompt=p, n_new=6)).tokens
            for p in prompts]
    paged = _paged(m, params, n_slots=3)
    got = [paged.generate(GenerateSpec(prompt=p, n_new=6)).tokens
           for p in prompts]
    assert got == want
    assert paged.stats()["kv_prefix_hits"] == 4   # 2 shared pages x 2
    jsched = JScheduler(jm, jparams, n_slots=3, cache_len=CACHE_LEN,
                        kv_page_tokens=PT, kv_max_seq=CACHE_LEN)
    assert [jsched.generate(JSpec(prompt=p.astype(np.int32),
                                  n_new=6)).tokens for p in prompts] == want
    assert jsched.stats()["kv_prefix_hits"] == 4


def test_paged_admits_mixed_lengths_beyond_slotted_ceiling(dense):
    cfg, m, params, _, _ = dense
    long_prompt = _prompt(cfg, 42, n=40)   # 40 + 8 > 32: slotted rejects
    with pytest.raises(CacheOverflowError):
        DecodeScheduler(m, params, n_slots=2, cache_len=32).generate(
            GenerateSpec(prompt=long_prompt, n_new=8))
    paged = _paged(m, params, cache_len=32, kv_page_tokens=8,
                   kv_max_seq=64, kv_budget_bytes=8 * m.kv_page_bytes(8))
    assert paged.n_pages == 8
    prompts = [long_prompt, _prompt(cfg, 43, n=9)]
    got = _concurrent(paged, [GenerateSpec(prompt=p, n_new=8, seed=i)
                              for i, p in enumerate(prompts)])
    for i, (p, r) in enumerate(zip(prompts, got)):
        assert r.tokens == reference_generate(m, params, p, n_new=8,
                                              cache_len=64, seed=i,
                                              device="cpu")
    paged.kvpool.check_invariants()


def test_shared_prefix_pins_same_physical_pages(dense):
    cfg, m, params, _, _ = dense
    sched = _paged(m, params)
    shared = _prompt(cfg, 100, n=2 * PT)
    pa = np.concatenate([shared, _prompt(cfg, 101, n=6)])
    ra = sched.generate(GenerateSpec(prompt=pa, n_new=6, seed=3))
    st_a = sched.kvpool.stats()
    assert st_a.prefix_hits == 0
    pb = np.concatenate([shared, _prompt(cfg, 102, n=4)])
    rb = sched.generate(GenerateSpec(prompt=pb, n_new=6, seed=4))
    st_b = sched.kvpool.stats()
    assert st_b.prefix_hits == 2
    assert st_b.used - st_a.used <= 1
    assert ra.tokens == _ref(m, params, pa, n_new=6, seed=3)
    assert rb.tokens == _ref(m, params, pb, n_new=6, seed=4)
    # a page-aligned prompt of the shared pages alone hits one page, not
    # two: a hit must leave a non-empty prefill suffix
    ref = _ref(m, params, shared, n_new=5, seed=9)
    for _ in range(2):
        assert sched.generate(GenerateSpec(prompt=shared, n_new=5,
                                           seed=9)).tokens == ref
    assert sched.kvpool.stats().prefix_hits == 2 + 1 + 1
    sched.kvpool.check_invariants()


def test_kv_metrics_wired(dense):
    cfg, m, params, _, _ = dense
    reg = MetricsRegistry()
    sched = _paged(m, params, metrics=reg)
    sched.generate(GenerateSpec(prompt=_prompt(cfg, 1, n=PT + 1), n_new=4))
    snap = reg.snapshot()
    assert snap["gauges"]["kv/pages_total"]["value"] == sched.n_pages
    assert snap["gauges"]["kv/pages_pinned"]["value"] == 0
    assert snap["counters"]["kv/prefix_misses"] >= 1
    assert sched.stats()["kv_pages_total"] == sched.n_pages
