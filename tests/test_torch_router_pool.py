"""The port's Router, InstancePool and eviction policies (the concurrent
serving API), mirroring the reference's router/pool tests on instances
that stand in for models: no duplicate pipeline loads, scale-out,
inference-first priority under saturation, admission control, typed
errors, keep-alive edge cases, generation requests joining a live
instance, and ``run_trace``'s lifecycle held against the JAX package's
``run_trace`` on the same stand-ins.

Threads are synchronised with events (a stand-in blocks in its load until
the test releases it), never with sleeps."""
import threading
import time

import pytest

from repro.metrics import MetricsRegistry as JMetrics
from repro.serving import engine as jengine
from repro.serving import policy as jpolicy
from repro.serving.pool import InstancePool as JPool
from repro.serving.trace import Invocation as JInvocation
from repro_torch.core import ColdStartEngine
from repro_torch.core.decoupler import ShardSource
from repro_torch.metrics import MetricsRegistry
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving import engine as tengine
from repro_torch.serving import (AdmissionError, Autoscaler, GenerateSpec,
                                 InstancePool, KeepAliveTTL, NeverEvict,
                                 Request, RequestClass, Router,
                                 ServerlessPlatform, UnknownModelError,
                                 make_policy)
from repro_torch.serving.decode import GenResult
from repro_torch.serving.trace import Invocation
from repro_torch.store.store import WeightStore


class FakeInstance:
    """The FunctionInstance contract without a model.  A load blocks on
    ``gate`` (set by default) after setting ``loading``."""

    def __init__(self, gen_slots=4):
        self.params = None
        self.loads = 0
        self.gen_slots = gen_slots
        self.gate = threading.Event()
        self.gate.set()
        self.loading = threading.Event()

    @property
    def live(self):
        return self.params is not None

    def evict(self):
        self.params = None

    def _load(self):
        self.loads += 1
        self.loading.set()
        assert self.gate.wait(10.0), "load never released"
        self.params = {"w": 1}

    def invoke(self, batch):
        if not self.live:
            self._load()
            return None, {"cold": True, "load_s": 0.01, "infer_s": 0.0,
                          "utilization": 0.9}
        return None, {"cold": False, "load_s": 0.0, "infer_s": 0.001,
                      "utilization": 1.0}

    def generate(self, spec, *, on_live=None):
        cold = not self.live
        if cold:
            self._load()
        if on_live is not None:
            on_live()
        hold = getattr(spec, "hold", None)
        if hold is not None:            # stay resident until released
            assert hold.wait(10.0)
        t = time.monotonic()
        res = GenResult([1] * spec.n_new, [t] * spec.n_new, 3)
        return res, {"cold": cold, "load_s": 0.01 if cold else 0.0,
                     "infer_s": 0.0, "utilization": 1.0}


def fake_pool(name="m", *, max_instances=1, policy=None, registry=None,
              pool_cls=InstancePool, metrics=None, gate=None,
              inst_cls=FakeInstance):
    """A pool of stand-ins; with ``gate`` every load waits on it."""
    insts = registry if registry is not None else []

    def factory():
        inst = inst_cls()
        if gate is not None:
            inst.gate = gate
        insts.append(inst)
        return inst

    return pool_cls(name, builder=None, policy=policy,
                    max_instances=max_instances, instance_factory=factory,
                    metrics=metrics)


def _req(i, model="m", cls=None, t=0.0):
    return Request(req_id=i, model=model, batch={}, t_logical=t, cls=cls)


def _wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# concurrent cold starts
# ---------------------------------------------------------------------------

def test_concurrent_cold_single_instance_one_pipeline():
    """Four concurrent invocations of a cold model with max_instances=1:
    one pipeline load runs; followers are served warm."""
    insts = []
    pool = fake_pool(max_instances=1, registry=insts)
    with Router({"m": pool}, workers=4) as router:
        futs = [router.submit(_req(i)) for i in range(4)]
        responses = [f.result(timeout=10) for f in futs]
    assert len(insts) == 1 and insts[0].loads == 1
    assert sum(r.cold for r in responses) == 1
    assert pool.stats().warm_hits == 3


def test_concurrent_cold_scales_out_no_duplicate_loads():
    """With max_instances=4 and every load held open, four concurrent
    cold invocations scale out onto four instances, each loading once."""
    insts = []
    gate = threading.Event()
    pool = fake_pool(max_instances=4, registry=insts, gate=gate)
    with Router({"m": pool}, workers=4) as router:
        futs = [router.submit(_req(i)) for i in range(4)]
        _wait(lambda: len(insts) == 4 and
              all(i.loading.is_set() for i in insts),
              "four loads never ran at once")
        assert router.stats.max_in_flight == 4
        gate.set()
        responses = [f.result(timeout=10) for f in futs]
    assert all(i.loads == 1 for i in insts)
    assert sum(r.cold for r in responses) == 4
    st = pool.stats()
    assert (st.size, st.cold_starts, st.warm_hits) == (4, 4, 0)


# ---------------------------------------------------------------------------
# priority dispatch, admission control, typed errors
# ---------------------------------------------------------------------------

def _blocked(router, pool, insts):
    """Submit a request whose cold load holds the router's one worker."""
    blocker = router.submit(_req(0))
    _wait(lambda: insts and insts[0].loading.is_set(),
          "the blocker was never dispatched")
    return blocker


def _held_pool(**kw):
    """A pool whose loads wait until the test sets its instance's gate."""
    insts = []
    return fake_pool(registry=insts, gate=threading.Event(), **kw), insts


def test_inference_first_ordering_under_saturated_router():
    """One worker busy in a load, three queued requests with explicit
    classes: dispatch order is INFERENCE < COLDSTART < BACKGROUND
    whatever the submit order."""
    pool, insts = _held_pool()
    done = []
    with Router({"m": pool}, workers=1) as router:
        blocker = _blocked(router, pool, insts)
        futs = []
        for rid, cls in [(1, RequestClass.BACKGROUND),
                         (2, RequestClass.COLDSTART),
                         (3, RequestClass.INFERENCE)]:
            f = router.submit(_req(rid, cls=cls))
            f.add_done_callback(
                lambda fut: done.append(fut.result().req_id))
            futs.append(f)
        insts[0].gate.set()
        blocker.result(timeout=10)
        for f in futs:
            f.result(timeout=10)
    assert done == [3, 2, 1]


def test_default_classification_inference_when_warm():
    pool = fake_pool(max_instances=1)
    with Router({"m": pool}, workers=1) as router:
        r0 = router.submit(_req(0)).result(timeout=10)
        assert r0.cls == RequestClass.COLDSTART       # nothing live yet
        r1 = router.submit(_req(1)).result(timeout=10)
        assert r1.cls == RequestClass.INFERENCE       # warm-servable
        assert r1.queue_s >= 0 and r1.latency_s >= 0


def test_admission_control_and_typed_errors():
    pool, insts = _held_pool()
    with Router({"m": pool}, workers=1, max_pending=1) as router:
        blocker = _blocked(router, pool, insts)
        ok = router.submit(_req(1))       # fills the one pending slot
        with pytest.raises(AdmissionError):
            router.submit(_req(2))
        with pytest.raises(UnknownModelError, match="nope"):
            router.submit(_req(3, model="nope"))
        assert isinstance(UnknownModelError("x"), KeyError)
        insts[0].gate.set()
        blocker.result(timeout=10)
        ok.result(timeout=10)
    st = router.stats
    assert (st.submitted, st.rejected, st.completed) == (2, 1, 2)
    with pytest.raises(RuntimeError, match="shut down"):
        router.submit(_req(4))


def test_failed_request_resolves_its_future_and_worker_survives():
    """A request that raises inside a worker comes back as a failed
    future (nothing swallows it); the instance is released and the
    worker keeps serving."""
    class FailsOnce(FakeInstance):
        failed = False

        def invoke(self, batch):
            if not self.failed:
                self.failed = True
                raise RuntimeError("boom")
            return super().invoke(batch)

    pool = fake_pool(inst_cls=FailsOnce)
    with Router({"m": pool}, workers=1) as router:
        with pytest.raises(RuntimeError, match="boom"):
            router.submit(_req(0)).result(timeout=10)
        assert router.submit(_req(1)).result(timeout=10).cold
    assert (router.stats.submitted, router.stats.completed) == (2, 1)
    assert router.metrics.counter("router/errors").value == 1
    assert pool.stats().busy == 0


# ---------------------------------------------------------------------------
# instance pool + eviction policies
# ---------------------------------------------------------------------------

def test_acquire_timeout_and_warm_idle_preferred():
    insts = []
    pool = fake_pool(max_instances=1, registry=insts)
    inst = pool.acquire()
    with pytest.raises(TimeoutError):
        pool.acquire(timeout=0.01)
    inst.invoke({})
    pool.release(inst, logical_now=0.0, cold=True)
    assert pool.acquire(timeout=0.1) is inst      # warm idle reused
    pool.release(inst, logical_now=0.0, cold=False)
    wide = fake_pool(max_instances=4, registry=insts)
    a = wide.acquire()
    a.invoke({})
    wide.release(a, logical_now=0.0, cold=True)
    assert wide.acquire() is a and len(insts) == 2


def test_policies_match_reference():
    idle = [0.0, 1e-9, 59.999, 60.0, 60.0 + 1e-9, 1e12]
    for ka in (None, float("inf"), 0.0, 60.0):
        port, ref = make_policy(ka), jpolicy.make_policy(ka)
        assert type(port).__name__ == type(ref).__name__
        assert repr(port) == repr(ref)
        assert [port.should_evict(s) for s in idle] == \
            [ref.should_evict(s) for s in idle]
    assert isinstance(make_policy(None), NeverEvict)
    with pytest.raises(ValueError):
        KeepAliveTTL(-1.0)


def test_sweep_ttl_zero_never_evict_and_busy_instances():
    pool = fake_pool(policy=KeepAliveTTL(0.0))
    inst = pool.acquire()
    inst.invoke({})
    pool.release(inst, logical_now=0.0, cold=True)
    assert pool.sweep(0.0) == 0           # no idle time elapsed yet
    assert pool.sweep(1e-9) == 1 and not inst.live
    inst = pool.acquire()
    inst.invoke({})
    pool.release(inst, logical_now=0.0, cold=True)
    assert pool.acquire() is inst         # busy again
    assert pool.sweep(100.0) == 0 and inst.live   # busy: never offered
    pool.release(inst, logical_now=100.0, cold=False)
    assert pool.sweep(200.0) == 1
    assert pool.stats().evictions == 2
    never = fake_pool(policy=NeverEvict())
    inst = never.acquire()
    inst.invoke({})
    never.release(inst, logical_now=0.0, cold=True)
    assert never.sweep(1e12) == 0 and inst.live


# ---------------------------------------------------------------------------
# generation: joiners share one live instance
# ---------------------------------------------------------------------------

def test_generation_requests_join_a_live_instance():
    """A cold generation request holds its instance for the load; once
    live (mark_live), the others join it while it is still resident —
    the pool's live gen_active gauge records the peak."""
    metrics = MetricsRegistry()
    insts = []
    pool = fake_pool(max_instances=1, registry=insts, metrics=metrics)
    hold = threading.Event()
    specs = []
    for i in range(3):
        spec = GenerateSpec(prompt=[1, 2, 3], n_new=4)
        spec.hold = hold
        specs.append(spec)
    with Router({"m": pool}, workers=3) as router:
        futs = [router.submit(Request(req_id=i, model="m", gen=specs[i]))
                for i in range(3)]
        _wait(lambda: pool.stats().gen_active == 3,
              "generation requests never joined")
        assert pool.stats().size == 1 and insts[0].loads == 1
        hold.set()
        out = [f.result(timeout=10) for f in futs]
    assert sum(r.cold for r in out) == 1
    assert all(list(r.tokens) == [1] * 4 and r.n_generated == 4
               for r in out)
    assert metrics.gauge("pool/m/gen_active").max == 3
    st = pool.stats()
    assert (st.gen_active, st.busy, st.cold_starts, st.warm_hits) == \
        (0, 0, 1, 2)


# ---------------------------------------------------------------------------
# run_trace's lifecycle, against the reference's run_trace
# ---------------------------------------------------------------------------

def _fake_platform(mod, pool_cls, metrics_cls, policy):
    """A platform of ``mod`` (the port's or the reference's engine module)
    whose pool is made of stand-ins: exercises run_trace's submission,
    sweep and clock logic alone."""
    platform = mod.ServerlessPlatform.__new__(mod.ServerlessPlatform)
    platform.policy = policy
    platform.cache = None
    platform.metrics = metrics_cls()
    platform.autoscaler = None
    platform.pools = {"m": fake_pool(policy=policy, pool_cls=pool_cls,
                                     metrics=platform.metrics)}
    platform.last_router_stats = None
    return platform


@pytest.mark.parametrize("ka,ts,concurrency", [
    (120.0, [0.0, 1.0, 300.0], 1),         # warm within, cold past the TTL
    (0.0, [0.0, 1.0, 2.0], 1),             # TTL 0: every request cold
    (None, [0.0, 1e6, 2e6], 1),            # never evict
    (45.0, [0.0, 100.0], 2),               # concurrent replay keeps TTL
], ids=["ttl120", "ttl0", "never", "concurrent"])
def test_run_trace_lifecycle_matches_reference(ka, ts, concurrency):
    got = {}
    for side, mod, pool_cls, mcls, pol, inv in (
            ("port", tengine, InstancePool, MetricsRegistry, make_policy,
             Invocation),
            ("ref", jengine, JPool, JMetrics, jpolicy.make_policy,
             JInvocation)):
        platform = _fake_platform(mod, pool_cls, mcls, pol(ka))
        out = platform.run_trace([inv(t, "m", i) for i, t in enumerate(ts)],
                                 lambda name: {}, concurrency=concurrency)
        st = platform.pools["m"].stats()
        rs = platform.last_router_stats
        got[side] = ([r.req_id for r in out], [r.cold for r in out],
                     (st.cold_starts, st.warm_hits, st.evictions),
                     (rs.submitted, rs.completed, rs.rejected))
    assert got["port"] == got["ref"]


def test_unported_options_raise(tmp_path):
    store = WeightStore(str(tmp_path))
    for kw in (dict(mesh_shape=4), dict(rules={})):
        with pytest.raises(NotImplementedError, match="item 13"):
            ServerlessPlatform(store, {}, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="item 13"):
        InstancePool("m", None, store, mesh_shape=(1, 4))
    # the cluster's source= is ported: the platform hands it to its pools
    src = ShardSource()
    plat = ServerlessPlatform(store, {"m": None}, device="cpu",
                              cache_budget_bytes=0, source=src)
    assert plat.source is src and plat.pools["m"].source is src
    # the autoscaler is ported: autoscale= builds one over the platform's
    # pools, and every router the platform makes reports to it
    plat = ServerlessPlatform(store, {}, device="cpu",
                              autoscale={"rps_per_instance": 3.0})
    asc = plat.autoscaler
    assert isinstance(asc, Autoscaler) and asc.pools is plat.pools
    assert asc.rps_per_instance == 3.0 and asc.metrics is plat.metrics
    router = plat.router(workers=1)
    try:
        assert router.autoscaler is asc and asc.router is router
    finally:
        router.shutdown()
        asc.stop()
    pool = InstancePool("m", None, instance_factory=FakeInstance)
    asc = Autoscaler({"m": pool}, metrics=MetricsRegistry())
    with Router({"m": pool}, autoscaler=asc) as router:
        assert asc.router is router
        router.submit(Request(req_id=0, model="m", batch={})).result(10)
        assert asc.rate_estimate("m") > 0          # the arrival observed
    asc.stop()
    m = transformer.build(get_config("smollm-360m", smoke=True),
                          device="cpu")
    for kw in (dict(mesh=object()), dict(rules={})):
        with pytest.raises(NotImplementedError, match="item 13"):
            ColdStartEngine(m, "m", store, device="cpu", **kw)
    assert ColdStartEngine(m, "m", store, device="cpu",
                           source=src).source is src
