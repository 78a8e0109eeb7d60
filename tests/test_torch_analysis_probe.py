"""The port's runtime lock probe (``repro_torch.analysis.locks``): every
probe case of the reference's ``tests/test_analysis.py`` re-aimed at the
port (the factory's plain primitives when off, observed edges and cycles,
I/O hazards, condition waits that drop their lock, ``wait_for``, the
merge with the static graph), and barrier-released thread storms over the
port's ``WeightCache`` and ``InstancePool`` under ``REPRO_ANALYZE=1``:
exact final state, no lock-order cycle, no lock held across I/O.  Each
storm's threads are joined with a time limit of their own."""
import os
import sys
import threading
import time

import pytest

from repro_torch.analysis import lint as L
from repro_torch.analysis import lockgraph as G
from repro_torch.analysis import locks as RL

from torch_testlib import PORT

STORM_JOIN_S = 30.0


@pytest.fixture
def analyze(monkeypatch):
    monkeypatch.setenv("REPRO_ANALYZE", "1")
    RL.probe.reset()
    yield RL.probe
    RL.probe.reset()


def _storm(worker, n_threads):
    """Run ``worker(tid)`` on ``n_threads`` threads released together by
    a barrier; returns the errors they raised.  Fails if a thread is
    still running after ``STORM_JOIN_S``."""
    barrier = threading.Barrier(n_threads)
    errors = []

    def run(tid):
        try:
            barrier.wait()
            worker(tid)
        except BaseException as e:               # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)                  # interleave more often
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + STORM_JOIN_S
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads), "storm did not finish"
    return errors


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

def test_factory_returns_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_ANALYZE", raising=False)
    assert isinstance(RL.make_lock("x"), type(threading.Lock()))
    assert isinstance(RL.make_rlock("x"), type(threading.RLock()))
    assert isinstance(RL.make_condition("x"), threading.Condition)
    monkeypatch.setenv("REPRO_ANALYZE", "0")
    assert not RL.enabled()


def test_probe_observes_edges_and_detects_inversion(analyze):
    a, b = RL.make_lock("A"), RL.make_lock("B")
    with a:
        with b:
            pass
    assert analyze.cycles() == []
    with b:
        with a:                      # inversion: closes A->B->A
            pass
    cycles = analyze.cycles()
    assert len(cycles) == 1 and set(cycles[0]) == {"A", "B"}
    rep = analyze.report()
    assert {(e["src"], e["dst"]) for e in rep["edges"]} \
        == {("A", "B"), ("B", "A")}


def test_probe_io_hazard_only_under_held_lock(analyze):
    a = RL.make_lock("A")
    RL.note_io("read_unit")                  # no lock held: fine
    assert analyze.report()["hazards"] == []
    with a:
        RL.note_io("read_unit")
    hz = analyze.report()["hazards"]
    assert hz == [{"io": "read_unit", "held": ["A"],
                   "thread": threading.current_thread().name}]


def test_condition_wait_suspends_held_lock(analyze):
    cv = RL.make_condition("CV")
    seen = {}
    done = []
    parked = threading.Event()

    def waiter():
        with cv:
            parked.set()
            while not done:
                cv.wait()

    t = threading.Thread(target=waiter)
    t.start()
    assert parked.wait(5.0)
    # while the waiter is parked its lock is SUSPENDED: this thread
    # acquires it, and the probe records no edge for it
    with cv:
        seen["acquired_while_waiting"] = True
        done.append(1)
        cv.notify_all()
    t.join(timeout=5)
    assert not t.is_alive() and seen["acquired_while_waiting"]
    rep = analyze.report()
    assert rep["cv_waits"]["CV"]["waits"] >= 1
    assert rep["cv_waits"]["CV"]["timed_waits"] == 0
    assert rep["cycles"] == [] and rep["edges"] == []


def test_probe_wait_for_records_waits(analyze):
    cv = RL.make_condition("CV2")
    done = []

    def setter():
        with cv:
            done.append(1)
            cv.notify_all()

    with cv:
        t = threading.Thread(target=setter)
        t.start()                    # blocks on cv until wait_for drops it
        assert cv.wait_for(lambda: done, timeout=5.0)
    t.join()
    rec = analyze.report()["cv_waits"]["CV2"]
    assert rec["waits"] >= 1 and rec["timed_waits"] == rec["waits"]


def test_merge_static_and_observed_graphs(analyze, tmp_path):
    a, b = RL.make_lock("X"), RL.make_lock("Y")
    with a:
        with b:
            pass
    obs = tmp_path / "probe.json"
    analyze.dump(str(obs))
    static_edges = [L.LockEdge("Y", "X", "m.py:1")]
    report = G.merge(static_edges, G.load_observed(str(obs)))
    assert [tuple(c) for c in report["cycles"]] == [("X", "Y")]
    text = G.render(report)
    assert "CYCLES" in text and "X -> Y" in text


# ---------------------------------------------------------------------------
# thread storms: the port's cache and pool under the probe
# ---------------------------------------------------------------------------

def test_fuzz_weight_cache_storm(analyze):
    from repro_torch.metrics import MetricsRegistry
    from repro_torch.store.cache import HIT, LOAD, WeightCache

    cache = WeightCache(budget_bytes=3_000,      # forces evictions
                        metrics=MetricsRegistry())
    cache.register_load("m")
    units = [f"u{i}" for i in range(6)]

    def worker(tid):
        for i in range(30):
            u = units[(tid + i) % len(units)]
            status, leaves = cache.begin("m", u)
            if status == LOAD:
                cache.complete("m", u, {"w": tid}, 1_000)
            else:
                assert status == HIT and leaves is not None
            cache.release("m", u)

    assert _storm(worker, 8) == []
    cache.unregister_load("m")
    st = cache.stats()
    assert st.pinned == 0 and st.hits + st.misses == 8 * 30
    rep = analyze.report()
    assert rep["cycles"] == []
    assert rep["hazards"] == []
    assert rep["locks"]["WeightCache._cv"]["acquires"] > 0


def test_fuzz_instance_pool_storm(analyze):
    from repro_torch.metrics import MetricsRegistry
    from repro_torch.serving.pool import InstancePool

    class _Dummy:
        gen_slots = 4

        def __init__(self):
            self.params = None

        @property
        def live(self):
            return self.params is not None

        def evict(self):
            self.params = None

    pool = InstancePool("m", builder=None, max_instances=3,
                        instance_factory=_Dummy, metrics=MetricsRegistry())

    def worker(tid):
        for i in range(25):
            if (tid + i) % 2:
                try:
                    inst = pool.acquire(timeout=5.0, logical_now=i)
                except TimeoutError:
                    continue
                inst.params = {"w": 1}
                pool.release(inst, logical_now=i, cold=False)
            else:
                try:
                    inst, joinable = pool.acquire_gen(timeout=5.0)
                except TimeoutError:
                    continue
                if not joinable:
                    inst.params = {"w": 1}
                    pool.mark_live(inst)
                pool.release_gen(inst, logical_now=i)

    assert _storm(worker, 8) == []
    st = pool.stats()
    assert st.busy == 0 and st.gen_active == 0
    rep = analyze.report()
    assert rep["cycles"] == []
    assert rep["hazards"] == []
    assert rep["locks"]["InstancePool._cv"]["acquires"] > 0
    # and the two fuzzed modules are R1-clean statically
    fs = L.lint_paths([os.path.join(str(PORT), "store", "cache.py"),
                       os.path.join(str(PORT), "serving", "pool.py")])
    assert [f for f in fs if f.rule == "R1"] == []
