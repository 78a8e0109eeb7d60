"""The port's SLO autoscaler (``repro_torch.serving.autoscale``): every case
of the reference's ``tests/test_autoscale.py`` on the port's
``InstancePool`` with the same warmable stand-in instance (logical-clock
scale-out and scale-in, in-flight suppression, the queue-depth term, the
background loop, the metrics registry and the autoscaler under the lock
probe); one logical-clock script of ``observe`` and ``tick`` calls fed to
both packages' autoscalers, with equal targets, dispatches, scale-ins and
pool stats at every tick; and both packages' ``ServerlessPlatform(
autoscale=...)`` over one store the JAX package deployed, prewarmed by
one such script, then serving the same requests warm: equal pool stats,
logits within 1e-4 of max |logit| at f32, equal tokens."""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.metrics import MetricsRegistry as JMetrics
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import engine as jengine
from repro.serving import pool as jpool
from repro.serving.api import GenerateSpec as JSpec
from repro.serving.api import Request as JRequest
from repro.serving.autoscale import Autoscaler as JAutoscaler
from repro.serving.pool import InstancePool as JPool
from repro.store import store as jstore
from repro_torch import analysis as RL
from repro_torch.metrics import MetricsRegistry
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving import (Autoscaler, GenerateSpec, Request,
                                 ServerlessPlatform)
from repro_torch.serving import pool as tpool
from repro_torch.serving.pool import InstancePool
from repro_torch.store.store import WeightStore

torch.set_num_threads(2)


class WarmableInstance:
    """FunctionInstance's prewarm contract (ensure_live) without a model."""
    gen_slots = 4

    def __init__(self, load_s=0.0):
        self.params = None
        self.loads = 0
        self.load_s = load_s

    @property
    def live(self):
        return self.params is not None

    def ensure_live(self):
        if self.live:
            return False
        if self.load_s:
            time.sleep(self.load_s)
        self.loads += 1
        self.params = {"w": 1}
        return True

    def evict(self):
        self.params = None


def _pool(max_instances=4, load_s=0.0, metrics=None, pool_cls=InstancePool):
    return pool_cls("m", builder=None, max_instances=max_instances,
                    instance_factory=lambda: WarmableInstance(load_s),
                    metrics=metrics)


def _wait_live(pool, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pool.stats().live >= n:
            return True
        time.sleep(0.01)
    return False


def _drain(asc):
    """Wait until no prewarm dispatched by ``asc`` is still in flight."""
    with asc._cv:
        while any(asc._inflight.values()):
            asc._cv.wait(5.0)


class _Router:
    def __init__(self, depth):
        self.depth = depth

    def queue_depth(self):
        return self.depth


# ---------------------------------------------------------------------------
# scale-out: rate slope -> pre-provisioned warm instances
# ---------------------------------------------------------------------------

def test_rising_arrival_slope_preprovisions_warm_instances():
    pool = _pool(max_instances=4)
    m = MetricsRegistry()
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0, window_s=4.0,
                     horizon_s=2.0, queue_per_instance=0, metrics=m)
    try:
        # flat trickle (~0.5 rps): one instance is enough
        asc.observe("m", now=0.0)
        asc.observe("m", now=2.0)
        assert asc.target_warm("m", now=4.0) == 1
        # rising ramp: 8 arrivals in the recent 2 s; the positive slope
        # is extrapolated horizon_s ahead, past the raw recent rate
        for i in range(8):
            asc.observe("m", now=4.0 + i * 0.25)
        assert asc.rate_estimate("m", now=6.0) > 4.0
        assert asc.target_warm("m", now=6.0) == 4  # clamped to the pool
        asc.tick(now=6.0)                          # dispatches prewarms
        assert _wait_live(pool, 4)
    finally:
        asc.stop()                                 # drains in-flight jobs
    st = pool.stats()
    assert st.live == 4 and st.prewarms == 4
    # prewarms are provisioning, not served requests
    assert st.cold_starts == 0 and st.warm_hits == 0
    assert m.counter("autoscaler/m/prewarms").value == 4
    assert m.gauge("autoscaler/m/target").value == 4


def test_tick_does_not_duplicate_inflight_prewarms():
    """A tick while prewarms are still loading must not dispatch the
    deficit again (the in-flight count covers it)."""
    pool = _pool(max_instances=4, load_s=0.2)
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0, window_s=4.0,
                     horizon_s=2.0, queue_per_instance=0,
                     max_prewarm_workers=4, metrics=MetricsRegistry())
    try:
        for i in range(8):
            asc.observe("m", now=i * 0.25)
        asc.tick(now=2.0)
        asc.tick(now=2.05)                         # loads still running
        asc.tick(now=2.10)
        assert _wait_live(pool, 4)
    finally:
        asc.stop()
    st = pool.stats()
    assert st.size == 4 and st.prewarms == 4       # not 12


# ---------------------------------------------------------------------------
# scale-in: idle window -> reclaim, never below min_warm
# ---------------------------------------------------------------------------

def test_scale_in_reclaims_idle_capacity_after_idle_window():
    pool = _pool(max_instances=4)
    m = MetricsRegistry()
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0, window_s=4.0,
                     horizon_s=0.0, queue_per_instance=0,
                     idle_scale_in_s=10.0, min_warm=1, metrics=m)
    try:
        for i in range(8):
            asc.observe("m", now=i * 0.25)         # burst justifies 4
        asc.tick(now=2.0)
        assert _wait_live(pool, 4)
        # idle, but shorter than the scale-in window: keep capacity
        asc.tick(now=5.0)
        assert pool.stats().live == 4
        # idle past the window: back to min_warm, evictions counted
        asc.tick(now=30.0)
        assert pool.stats().live == 1
        assert m.counter("autoscaler/m/scale_ins").value == 3
        assert pool.stats().evictions == 3
    finally:
        asc.stop()


def test_scale_in_never_evicts_gen_held_instances():
    """An instance with a resident generation lives in the pool's busy
    list until its last shared hold drops — scale-in (idle-only) cannot
    reach it, via the direct call or the autoscaler's idle tick."""
    pool = _pool(max_instances=2, metrics=MetricsRegistry())
    assert pool.prewarm() and pool.prewarm()
    assert pool.stats().live == 2
    inst, joinable = pool.acquire_gen()
    assert joinable and inst.live
    assert pool.scale_in(0) == 1                   # only the idle one
    assert inst.live
    st = pool.stats()
    assert st.live == 1 and st.gen_active == 1
    # the autoscaler's most aggressive case: zero target, idle forever
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0,
                     queue_per_instance=0, idle_scale_in_s=0.0,
                     metrics=MetricsRegistry())
    try:
        asc.tick(now=1e9)
    finally:
        asc.stop()
    assert inst.live and pool.stats().gen_active == 1
    # once the generation leaves, the instance is ordinary idle capacity
    pool.release_gen(inst)
    assert pool.scale_in(0) == 1
    assert not inst.live


def test_prewarm_is_not_a_served_request():
    pool = _pool(max_instances=2, metrics=MetricsRegistry())
    assert pool.prewarm() is True
    st = pool.stats()
    assert st.prewarms == 1 and st.live == 1
    assert st.cold_starts == 0 and st.warm_hits == 0
    assert pool.prewarm() is True                  # scales out
    assert pool.prewarm() is False                 # at max, all live
    assert pool.stats().prewarms == 2


# ---------------------------------------------------------------------------
# queue-depth term + background loop
# ---------------------------------------------------------------------------

def test_queue_depth_term_adds_capacity_when_rate_lags():
    pool = _pool(max_instances=4, metrics=MetricsRegistry())
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0, window_s=4.0,
                     queue_per_instance=4, metrics=MetricsRegistry())
    try:
        asc.router = _Router(0)
        assert asc.target_warm("m", now=0.0) == 0  # no arrivals, no queue
        # a backlog the rate estimate hasn't seen yet forces capacity
        asc.router = _Router(12)
        assert asc.target_warm("m", now=0.0) >= 2
    finally:
        asc.stop()


def test_background_loop_ticks_and_stops_clean():
    pool = _pool(max_instances=2, metrics=MetricsRegistry())
    m = MetricsRegistry()
    with Autoscaler({"m": pool}, rps_per_instance=1.0, interval_s=0.02,
                    queue_per_instance=0, metrics=m) as asc:
        asc.observe("m")
        deadline = time.monotonic() + 5.0
        while "autoscaler/m/target" not in m.names() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
    assert "autoscaler/m/target" in m.names()      # ticked at least once
    assert asc._thread is None                     # stopped by __exit__


# ---------------------------------------------------------------------------
# metrics registry and autoscaler under the instrumented lock probe
# ---------------------------------------------------------------------------

@pytest.fixture
def analyze(monkeypatch):
    monkeypatch.setenv("REPRO_ANALYZE", "1")
    RL.probe.reset()
    yield RL.probe
    RL.probe.reset()


def test_metrics_registry_concurrent_storm(analyze):
    """8 threads hammer one registry (create-or-get races included):
    exact final counts, and the probe sees zero lock cycles and zero
    I/O-under-lock hazards — instrument locks stay leaves.  The threads
    are joined with a time limit."""
    m = MetricsRegistry()
    n_threads, n_iter = 8, 300
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(tid):
        try:
            barrier.wait()
            for i in range(n_iter):
                m.counter("c").inc()
                m.counter(f"c{tid % 2}").inc(2)
                m.gauge("g").set(float(i))
                m.gauge("hw").add(1.0)
                m.histogram("h").observe(i * 1e-3)
        except BaseException as e:                 # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30.0
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not errors and not any(t.is_alive() for t in threads)
    total = n_threads * n_iter
    assert m.counter("c").value == total
    assert m.counter("c0").value + m.counter("c1").value == 2 * total
    assert m.gauge("hw").value == total
    snap = m.snapshot()
    assert snap["histograms"]["h"]["count"] == total
    rep = analyze.report()
    assert rep["cycles"] == []
    assert rep["hazards"] == []
    assert rep["locks"]["MetricsRegistry._lock"]["acquires"] > 0


def test_autoscaler_under_probe_no_cycles(analyze):
    """The full observe/tick/prewarm/scale-in loop under the probe:
    the autoscaler CV, pool CV and metric instruments interleave
    without closing a lock cycle or doing I/O under a lock."""
    m = MetricsRegistry()
    pool = _pool(max_instances=3, metrics=m)
    asc = Autoscaler({"m": pool}, rps_per_instance=1.0, window_s=2.0,
                     horizon_s=1.0, queue_per_instance=0,
                     idle_scale_in_s=5.0, metrics=m)
    try:
        for i in range(6):
            asc.observe("m", now=i * 0.25)
            asc.tick(now=i * 0.25)
        assert _wait_live(pool, 1)
        asc.tick(now=100.0)                        # idle -> scale-in
    finally:
        asc.stop()
    rep = analyze.report()
    assert rep["cycles"] == []
    assert rep["hazards"] == []
    assert rep["locks"]["Autoscaler._cv"]["acquires"] > 0
    assert ("Autoscaler._cv", "InstancePool._cv") not in {
        (e["src"], e["dst"]) for e in rep["edges"]}


# ---------------------------------------------------------------------------
# one logical-clock script, both packages
# ---------------------------------------------------------------------------

# (op, now, router queue depth): a trickle, a ramp, ticks while prewarms
# load, a backlog the rate has not seen, an idle stretch, a second burst
SCRIPT = ([("observe", 0.0, 0), ("observe", 2.0, 0), ("tick", 4.0, 0)]
          + [("observe", 4.0 + i * 0.25, 0) for i in range(8)]
          + [("tick", 6.0, 0), ("tick", 6.05, 0), ("tick", 7.0, 9),
             ("tick", 12.0, 0), ("tick", 30.0, 0)]
          + [("observe", 40.0 + i * 0.5, 0) for i in range(4)]
          + [("tick", 42.0, 0), ("tick", 43.0, 20), ("tick", 200.0, 0)])


def _run_script(autoscaler_cls, pool_cls, metrics_cls):
    m = metrics_cls()
    pool = _pool(max_instances=4, metrics=m, pool_cls=pool_cls)
    asc = autoscaler_cls({"m": pool}, rps_per_instance=0.8, window_s=4.0,
                         horizon_s=2.0, queue_per_instance=4,
                         idle_scale_in_s=10.0, min_warm=1,
                         max_prewarm_workers=2, metrics=m)
    router = _Router(0)
    asc.router = router
    dispatched = []
    dispatch = asc._dispatch_prewarm

    def counting_dispatch(model, now):
        dispatched.append((model, now))
        dispatch(model, now)

    asc._dispatch_prewarm = counting_dispatch
    out = []
    try:
        for op, now, depth in SCRIPT:
            router.depth = depth
            if op == "observe":
                asc.observe("m", now=now)
                continue
            targets = asc.tick(now=now)
            _drain(asc)
            snap = m.snapshot()["counters"]
            out.append((now, targets, len(dispatched),
                        snap.get("autoscaler/m/prewarms", 0.0),
                        snap.get("autoscaler/m/scale_ins", 0.0),
                        dataclasses.asdict(pool.stats())))
    finally:
        asc.stop()
    return out


def test_logical_clock_script_matches_reference():
    got = _run_script(Autoscaler, InstancePool, MetricsRegistry)
    want = _run_script(JAutoscaler, JPool, JMetrics)
    assert got == want
    # the script exercises scale-out, the queue term and scale-in
    assert got[-1][2] >= 4 and got[-1][5]["prewarms"] >= 4
    assert any(row[4] > 0 for row in got)
    assert got[-1][5]["live"] == 1                 # back to min_warm


# ---------------------------------------------------------------------------
# both platforms, autoscaled, over one store
# ---------------------------------------------------------------------------

PROMPT, N_NEW = 6, 4
AUTOSCALE = dict(rps_per_instance=0.5, window_s=4.0, horizon_s=2.0,
                 queue_per_instance=0, idle_scale_in_s=1e9,
                 max_prewarm_workers=2)


def _platform_run(side, root, model, tokens, prompt):
    """Prewarm by the logical-clock script, then one one-shot and one
    generation request through the platform's router."""
    logits = []
    pool_mod = tpool if side == "port" else jpool
    orig = pool_mod.FunctionInstance.invoke

    def invoke(self, batch):
        out, info = orig(self, batch)
        logits.append(out.float().numpy() if side == "port"
                      else np.asarray(out, np.float32))
        return out, info

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pool_mod.FunctionInstance, "invoke", invoke)
        if side == "port":
            batch = {"tokens": torch.as_tensor(tokens)}
            plat = ServerlessPlatform(
                WeightStore(root), {"m": lambda: (model, batch)},
                strategy="cicada", max_instances=2, gen_slots=2,
                gen_cache_len=32, io_workers=1, device="cpu",
                autoscale=AUTOSCALE)
            req = (Request(req_id=0, model="m", batch=batch),
                   Request(req_id=1, model="m", gen=GenerateSpec(
                       prompt=prompt, n_new=N_NEW)))
        else:
            mp.setenv("REPRO_PALLAS", "ref")
            batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
            plat = jengine.ServerlessPlatform(
                jstore.WeightStore(root), {"m": lambda: (model, batch)},
                strategy="cicada", max_instances=2, gen_slots=2,
                gen_cache_len=32, io_workers=1, metrics=JMetrics(),
                autoscale=AUTOSCALE)
            req = (JRequest(req_id=0, model="m", batch=batch),
                   JRequest(req_id=1, model="m", gen=JSpec(
                       prompt=prompt.astype(np.int32), n_new=N_NEW)))
        asc = plat.autoscaler
        try:
            for i in range(6):
                asc.observe("m", now=i * 0.5)
            targets = asc.tick(now=3.0)
            _drain(asc)
            before = dataclasses.asdict(plat.pool_stats()["m"])
            router = plat.router(workers=1)
            try:
                resps = [router.submit(r).result(timeout=120) for r in req]
            finally:
                router.shutdown()
        finally:
            asc.stop()
    return (targets, before, dataclasses.asdict(plat.pool_stats()["m"]),
            resps, logits)


def test_autoscaled_platforms_match_reference(tmp_path):
    root = str(tmp_path / "store")
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jstore.deploy_model(jstore.WeightStore(root), jm, "m", jax.random.key(3))
    tm = transformer.build(tcfg, device="cpu")
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, 8))
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (PROMPT,))
    got = _platform_run("port", root, tm, tokens, prompt)
    want = _platform_run("ref", root, jm, tokens, prompt)
    assert got[0] == want[0] == {"m": 2}
    assert got[1] == want[1]                       # after the prewarms
    assert got[1]["prewarms"] == 2 and got[1]["live"] == 2
    assert got[1]["cold_starts"] == 0 and got[1]["warm_hits"] == 0
    assert got[2] == want[2]                       # after the requests
    assert got[2]["warm_hits"] == 2 and got[2]["cold_starts"] == 0
    tresp, jresp = got[3], want[3]
    assert [r.cold for r in tresp] == [r.cold for r in jresp] == [False] * 2
    assert list(tresp[1].tokens) == list(jresp[1].tokens)
    assert len(tresp[1].tokens) == N_NEW
    (tl,), (jl,) = got[4], want[4]
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=1e-4 * float(np.abs(jl).max()))
