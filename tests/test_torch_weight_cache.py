"""The port's node-local WeightCache and the scheduler's external-stream
rules, held against the JAX package: the same operation sequence on both
caches (budget-bounded LRU eviction, refcount pins, in-flight sparing,
single-flight, abort) gives the same stats, and the same stream events
on both schedulers give the same Algorithm 1 decisions.  Then cold
starts through the port's engine and pool on the CPU share one cache:
a second cold start reads nothing, concurrent scale-out single-flights
every read, a failed load leaves the cache healthy, and two loads that
lead each other's units do not deadlock.

Threads are synchronised with events and the cache's own condition
variable, never with sleeps."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.scheduler import PriorityAwareScheduler as JScheduler
from repro.store.cache import WeightCache as JCache
from repro_torch.core import ColdStartEngine
from repro_torch.core.scheduler import HIGH, NORMAL, PriorityAwareScheduler
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving.pool import InstancePool
from repro_torch.store.cache import HIT, LOAD, WeightCache
from repro_torch.store.store import BandwidthModel, WeightStore, deploy_model

torch.set_num_threads(2)


def _put(c, model, unit, nbytes, value=None):
    status, _ = c.begin(model, unit)
    assert status == LOAD
    c.complete(model, unit, value if value is not None else {unit: nbytes},
               nbytes)
    c.release(model, unit)          # drop the loader's pin


def _same_stats(port, ref):
    assert dataclasses.asdict(port.stats()) == \
        dataclasses.asdict(ref.stats())


def _wait_parked(c, n, timeout=10.0):
    """Block until ``n`` threads wait on the cache's condition variable."""
    deadline = time.monotonic() + timeout
    while len(c._cv._waiters) < n:
        assert time.monotonic() < deadline, "waiters never parked"
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# the cache alone, against the reference's
# ---------------------------------------------------------------------------

def test_budget_bounded_lru_eviction_order():
    for c in (WeightCache(budget_bytes=250), JCache(budget_bytes=250)):
        _put(c, "m", "u0", 100)
        _put(c, "m", "u1", 100)
        assert ("m", "u0") in c and ("m", "u1") in c
        # refresh u0's recency: u1 is now the LRU victim
        s, _ = c.begin("m", "u0")
        assert s == HIT
        c.release("m", "u0")
        _put(c, "m", "u2", 100)        # 300 > 250 -> one eviction
        st = c.stats()
        assert st.bytes_cached <= 250 and st.evictions == 1
        assert ("m", "u1") not in c            # LRU evicted first
        assert ("m", "u0") in c and ("m", "u2") in c
    port, ref = WeightCache(250), JCache(250)
    for c in (port, ref):
        for i in range(6):
            _put(c, "m" if i % 2 else "n", f"u{i}", 60 + 10 * i)
    _same_stats(port, ref)


def test_refcount_pin_survives_budget_pressure():
    port, ref = WeightCache(budget_bytes=100), JCache(budget_bytes=100)
    for c in (port, ref):
        status, _ = c.begin("m", "pinned")
        assert status == LOAD
        c.complete("m", "pinned", {"w": 1}, 80)   # loader's pin still held
        _put(c, "m", "other", 80)                 # over budget
        assert ("m", "pinned") in c               # in-use unit survives
        assert ("m", "other") not in c            # the unpinned one paid
        assert c.stats().pinned == 1
        c.release("m", "pinned")
        _put(c, "m", "next", 80)                  # pin dropped -> evictable
        assert ("m", "pinned") not in c
    _same_stats(port, ref)


def test_inflight_model_units_evicted_last():
    """Units of a model with a registered in-flight load are spared until
    idle models' units are gone."""
    port, ref = WeightCache(budget_bytes=150), JCache(budget_bytes=150)
    for c in (port, ref):
        _put(c, "busy", "u0", 100)
        c.register_load("busy")
        _put(c, "idle", "u0", 100)     # over budget: "idle" evicted
        assert ("busy", "u0") in c and ("idle", "u0") not in c
        c.unregister_load("busy")      # protection lapses
        _put(c, "idle2", "u0", 100)
        assert ("busy", "u0") not in c
        assert c._inflight == {}
    _same_stats(port, ref)


def test_single_flight_one_leader_many_waiters():
    for c in (WeightCache(None), JCache(None)):
        outcomes = []
        status, _ = c.begin("m", "u")          # this thread leads
        assert status == LOAD

        def follower():
            outcomes.append(c.begin("m", "u"))

        ts = [threading.Thread(target=follower) for _ in range(4)]
        for t in ts:
            t.start()
        _wait_parked(c, 4)             # every follower blocks on the leader
        assert not outcomes
        c.complete("m", "u", {"w": 42}, 10)
        for t in ts:
            t.join(10.0)
        assert outcomes == [(HIT, {"w": 42})] * 4
        st = c.stats()
        assert (st.misses, st.hits, st.waits, st.pinned) == (1, 4, 4, 1)
    # stress: more threads than cores on few keys under a budget, with a
    # short switch interval; no update may be lost
    c = WeightCache(budget_bytes=300)
    n_threads, n_ops = 16, 200
    begins = [0] * n_threads

    def worker(i):
        rng = np.random.default_rng(i)
        for _ in range(n_ops):
            key = ("m" if rng.random() < 0.5 else "n", f"u{rng.integers(6)}")
            status, leaves = c.begin(*key)
            begins[i] += 1
            if status == LOAD:
                if rng.random() < 0.1:
                    c.abort(*key)
                    continue
                c.complete(*key, {"k": key}, 100)
            else:
                assert leaves == {"k": key}
            c.release(*key)

    old_si = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60.0)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old_si)
    st = c.stats()
    assert st.hits + st.misses == sum(begins) == n_threads * n_ops
    assert st.pinned == 0 and st.bytes_cached <= 300
    assert st.bytes_cached == 100 * st.entries
    assert st.inserts - st.evictions == st.entries


def test_aborted_leader_promotes_a_waiter():
    for c in (WeightCache(None), JCache(None)):
        got = {}

        def follower():
            got["status"], _ = c.begin("m", "u")

        status, _ = c.begin("m", "u")
        assert status == LOAD
        t = threading.Thread(target=follower)
        t.start()
        _wait_parked(c, 1)
        c.abort("m", "u")              # leader's read failed
        t.join(10.0)
        assert got["status"] == LOAD   # the waiter retries as the leader
        c.complete("m", "u", {"w": 1}, 4)
        assert ("m", "u") in c and c.stats().misses == 2


def test_stats_clear_try_get_and_eviction_notice():
    evicted = {"port": [], "ref": []}
    port = WeightCache(budget_bytes=1000, on_evict=evicted["port"].append)
    ref = JCache(budget_bytes=1000, on_evict=evicted["ref"].append)
    for c in (port, ref):
        _put(c, "m", "u0", 100)
        s, _ = c.begin("m", "u0")
        assert s == HIT
        st = c.stats()
        assert st.entries == 1 and st.pinned == 1
        assert st.hit_rate == pytest.approx(0.5)
        c.clear()
        assert ("m", "u0") in c        # pinned entries survive clear()
        c.release("m", "u0")
        assert c.try_get("m", "absent") is None
        assert c.try_get("m", "u0") == {"u0": 100}  # a peek pins
        c.release("m", "u0")
        assert c.cached_units("m") == ["u0"]
        c.clear()
        assert ("m", "u0") not in c and c.stats().bytes_cached == 0
    assert evicted["port"] == evicted["ref"] == [("m", "u0", 0)]
    assert WeightCache(0).budget_bytes is None      # 0 means unbounded
    with pytest.raises(ValueError):
        WeightCache(-1)


# ---------------------------------------------------------------------------
# the scheduler's external streams, against the reference's
# ---------------------------------------------------------------------------

def test_scheduler_external_stream_rules_match_reference():
    """One event sequence on both schedulers: an external stream (served
    by the cache) is never made critical and arms no deadline, its
    completion leaves the bandwidth estimate alone, and once it is a
    local read again Algorithm 1 prioritizes it as before."""
    out = {}
    for name, cls in (("port", PriorityAwareScheduler), ("ref", JScheduler)):
        s = cls(bw_bytes_per_s=1e12, a_overhead_s=0.0)  # every read late
        log = []
        for u in ("u0", "u1", "u2"):
            s.register(u, 1000)
            s.on_issue(u)
        s.mark_external("u0")
        log.append(s.time_until_expected("u0"))
        log.append(s.adjust_priority("u0"))           # external: NORMAL
        log.append([s._streams[k].gate.is_set() for k in sorted(s._streams)])
        bw = s.stats()["bw_estimate"]
        s.on_complete("u0", observed=False)
        log.append(s.stats()["bw_estimate"] == bw)    # EMA untouched
        s.mark_external("u1")
        s.mark_external("u1", False)                  # a leader's read
        log.append(s.adjust_priority("u1"))           # late local: HIGH
        log.append([s._streams[k].gate.is_set() for k in sorted(s._streams)])
        log.append(s.time_until_expected("u1"))       # critical: none
        s.on_progress("u1", 500, 1000)
        s.on_complete("u1")                           # observed read
        log.append(s.stats()["bw_estimate"] != bw)
        log.append([s._streams[k].gate.is_set() for k in sorted(s._streams)])
        log.append(s.suspend_count)
        out[name] = log
    assert out["port"] == out["ref"]
    assert out["port"][:2] == [None, NORMAL] and out["port"][4] == HIGH


# ---------------------------------------------------------------------------
# cold starts through the port's engine and pool share one cache
# ---------------------------------------------------------------------------

class CountingStore(WeightStore):
    """WeightStore counting physical unit reads; ``fail_unit`` raises."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.reads = 0
        self.fail_unit = None
        self._lock = threading.Lock()

    def read_unit(self, model_name, unit, **kw):
        if unit == self.fail_unit:
            raise IOError("injected read failure")
        with self._lock:
            self.reads += 1
        return super().read_unit(model_name, unit, **kw)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype=torch.float32)
    m = transformer.build(cfg, device="cpu")
    store = CountingStore(str(tmp_path_factory.mktemp("store")),
                          BandwidthModel(bandwidth_mbps=150, latency_ms=0.3))
    deploy_model(store, m, "m", seed=3)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8)))}
    return store, m, batch


def _engine(store, m, cache, strategy="cicada"):
    return ColdStartEngine(m, "m", store, strategy=strategy,
                           chunk_bytes=1 << 15, cache=cache, device="cpu")


def test_second_cold_start_zero_reads_and_cached_retrieval(deployed):
    store, m, batch = deployed
    cache = WeightCache(None)
    n_units = len(m.unit_names())
    store.reads = 0
    # pins are dropped as each unit's application completes: by the final
    # unit's E (before the load shuts down) none is left
    pinned = []
    r1 = _engine(store, m, cache).load(
        batch, on_logits=lambda lg: pinned.append(cache.stats().pinned))
    assert store.reads == n_units
    assert not any(e.meta for e in r1.trace.events_for("R").values())
    r2 = _engine(store, m, cache).load(
        batch, on_logits=lambda lg: pinned.append(cache.stats().pinned))
    assert pinned == [0, 0]
    assert store.reads == n_units          # zero additional reads
    R = r2.trace.events_for("R")
    assert set(R) == set(m.unit_names())
    assert all(e.meta == {"cached": True} for e in R.values())
    torch.testing.assert_close(r2.logits, r1.logits, rtol=0, atol=0)
    st = cache.stats()
    assert (st.misses, st.hits, st.pinned) == (n_units, n_units, 0)
    assert st.bytes_cached == store.model_nbytes("m")


def test_concurrent_scale_out_single_flights_reads(deployed):
    store, m, batch = deployed
    cache = WeightCache(None)
    n_units = len(m.unit_names())
    engines = [_engine(store, m, cache) for _ in range(2)]
    store.reads = 0
    out = [None, None]

    def go(i):
        out[i] = engines[i].load(batch)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert all(o is not None for o in out)
    assert store.reads == n_units          # exactly one read per unit
    st = cache.stats()
    assert st.misses == n_units and st.hits + st.misses == 2 * n_units
    assert st.pinned == 0 and cache._inflight == {}
    torch.testing.assert_close(out[0].logits, out[1].logits, rtol=0, atol=0)


def test_mutual_leaders_do_not_deadlock(deployed):
    """Two loads of one model, each leading some units' reads and waiting
    on the other's, with Algorithm 1 on and a throttled store: both
    finish with equal logits.  (That a cache wait is never made critical
    — what keeps such loads from suspending each other's leaders — is
    checked exactly by the scheduler test above; unit-granular streams
    prioritized lowest-unit-first cannot form the cycle by themselves.)"""
    store, m, batch = deployed
    slow = CountingStore(store.root, BandwidthModel(bandwidth_mbps=20))
    cache = WeightCache(None)
    for _ in range(3):
        engines = [ColdStartEngine(m, "m", slow, strategy="cicada",
                                   chunk_bytes=1 << 12, io_workers=2,
                                   cache=cache, device="cpu")
                   for _ in range(2)]
        cache.clear()
        out, go = [None, None], threading.Barrier(2)

        def run(i):
            go.wait()
            out[i] = engines[i].load(batch)

        ts = [threading.Thread(target=run, args=(i,), daemon=True)
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120.0)
        assert not any(t.is_alive() for t in ts), "loads deadlocked"
        assert all(o is not None for o in out)
        torch.testing.assert_close(out[0].logits, out[1].logits, rtol=0,
                                   atol=0)
    assert cache.stats().pinned == 0


def test_pool_scale_out_shares_platform_cache(deployed):
    store, m, batch = deployed
    cache = WeightCache(None)
    n_units = len(m.unit_names())
    pool = InstancePool("m", lambda: (m, batch), store, strategy="cicada",
                        max_instances=2, chunk_bytes=1 << 15, cache=cache,
                        device="cpu")
    i1 = pool.acquire()
    i2 = pool.acquire()            # scale-out: second container
    assert i1 is not i2
    store.reads = 0
    i1.invoke(batch)               # cold: reads every unit
    assert store.reads == n_units
    i2.invoke(batch)               # cold, but cache-warm: zero reads
    assert store.reads == n_units
    pool.release(i1, logical_now=0.0, cold=True)
    pool.release(i2, logical_now=0.0, cold=True)
    assert pool.stats().cold_starts == 2


def test_failed_load_does_not_poison_shared_cache(deployed):
    """A cold start whose store read raises leaves the shared cache
    healthy: no wedged loading slot, no leaked pin, and the in-flight
    registration retired."""
    store, m, batch = deployed
    cache = WeightCache(None)
    bad_unit = m.unit_names()[2]
    store.fail_unit = bad_unit
    try:
        with pytest.raises(IOError, match="injected"):
            _engine(store, m, cache).load(batch)
    finally:
        store.fail_unit = None
    assert cache.stats().pinned == 0       # shutdown swept the pins
    assert cache._inflight == {}
    done = {}

    def probe():
        done["status"], _ = cache.begin("m", bad_unit)

    t = threading.Thread(target=probe)
    t.start()
    t.join(10.0)
    assert not t.is_alive(), "begin() wedged on a dead leader"
    assert done["status"] == LOAD
    cache.abort("m", bad_unit)
    res = _engine(store, m, cache).load(batch)   # the cache still serves
    assert res.logits.shape[-1] == m.cfg.vocab_size
    assert cache.stats().pinned == 0


@pytest.mark.parametrize("strategy", ["cicada", "pisel", "traditional"])
def test_cache_less_and_fused_loads_read_every_time(deployed, strategy):
    """No cache: every cold start re-reads.  Strategies without the
    decoupler ignore the cache and read the store as before."""
    store, m, batch = deployed
    n_units = len(m.unit_names())
    cache = None if strategy == "cicada" else WeightCache(None)
    store.reads = 0
    _engine(store, m, cache, strategy).load(batch)
    _engine(store, m, cache, strategy).load(batch)
    assert store.reads == 2 * n_units
    if cache is not None:
        assert cache.stats().misses == 0
