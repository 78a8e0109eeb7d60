"""The port's concurrency toolkit held against the reference's: the two
lints give the same finding IDs on shared fixture sources (one per rule
R1-R4, each with flagged and clean code) and on ``src/repro_torch``
itself, and the two probes, fed one script of acquisitions, condition
waits and ``note_io`` calls, report the same edges, cycles, hazards and
counts."""
import textwrap
import threading

import pytest

from repro.analysis import lint as JL
from repro.analysis import locks as JLocks
from repro_torch.analysis import lint as TL
from repro_torch.analysis import locks as TLocks

from torch_testlib import PORT

FIXTURES = {
    # a lock borrowed from another object is no lock to the lint: the
    # pattern the port's decoupler had before its cv assignment named a
    # factory
    "R1": """
        import threading

        class State:
            def __init__(self):
                self.cv = threading.Condition()

        class Borrower:
            def __init__(self, state):
                self.cv = state.cv
                self.ready = {}         # guarded-by: cv

            def put(self, k, v):
                with self.cv:
                    self.ready[k] = v

        class Owner:
            _guarded_by = {"_n": "_lock", "log": "_lock:writes"}

            def __init__(self, state):
                self._lock = state.lock if state else threading.Lock()
                self._n = 0
                self.log = []

            def good(self):
                with self._lock:
                    self._n += 1
                    self.log.append(self._n)
                return len(self.log)

            def bad(self):
                self.log.append(self._n)

            def _peek_locked(self):
                return self._n
    """,
    "R2": """
        import threading

        class C:
            def __init__(self):
                self._cv = threading.Condition()
                self.cond = threading.Condition()
                self.ready = False

            def bad_poll(self):
                with self._cv:
                    self._cv.wait(0.02)

            def bad_if(self):
                with self.cond:
                    if not self.ready:
                        self.cond.wait()

            def good(self, wait_s):
                with self._cv:
                    while not self.ready:
                        self._cv.wait(wait_s)

            def quiet(self):
                with self._cv:
                    self._cv.wait(1)  # analysis: ignore[R2]
    """,
    "R3": """
        import threading

        class Inner:
            def __init__(self):
                self._lock = threading.Lock()
                self._other = threading.RLock()

            def poke(self):
                with self._lock:
                    pass

            def back(self, outer: "Outer"):
                with self._other:
                    with self._lock:
                        pass

        class Outer:
            def __init__(self, inner: Inner):
                self._lock = threading.Lock()
                self.inner = inner

            def call(self):
                with self._lock:
                    self.inner.poke()

        class Loop:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a, self._b:
                    pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
    """,
    "R4": """
        import time

        def poll():
            time.sleep(0.1)

        class Waiter:
            def spin(self):
                while True:
                    time.sleep(0.01)

            def allowed(self):
                time.sleep(0)  # analysis: ignore[R4]
    """,
}


def _ids(findings):
    return sorted(f.id for f in findings)


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_lint_ids_match_reference_on_fixtures(rule):
    src = textwrap.dedent(FIXTURES[rule])
    got = TL.lint_source(src, "mod.py")
    want = JL.lint_source(src, "mod.py")
    assert _ids(got) == _ids(want)
    assert [f.line for f in sorted(got, key=lambda f: f.id)] == \
        [f.line for f in sorted(want, key=lambda f: f.id)]
    # each fixture flags its own rule, and nothing of another
    assert {f.rule for f in got} == {rule}
    tedges, tcyc = TL.build_static_lockgraph([TL.FileModel(src, "mod.py")])
    jedges, jcyc = JL.build_static_lockgraph([JL.FileModel(src, "mod.py")])
    assert sorted((e.src, e.dst, e.where) for e in tedges) == \
        sorted((e.src, e.dst, e.where) for e in jedges)
    assert tcyc == jcyc


def test_lint_ids_and_lock_graph_match_reference_on_the_port():
    got = TL.lint_paths([str(PORT)])
    want = [f for f in JL.lint_paths([str(PORT)]) if f.rule != "R5"]
    assert _ids(got) == _ids(want) == []
    tedges, tcyc = TL.build_static_lockgraph(TL.load_models(str(PORT)))
    jedges, jcyc = JL.build_static_lockgraph(JL.load_models(str(PORT)))
    assert sorted((e.src, e.dst, e.where) for e in tedges) == \
        sorted((e.src, e.dst, e.where) for e in jedges)
    assert tcyc == jcyc == []


def _probe_script(mod):
    """One fixed script against one package's factory and probe; returns
    the report without its timings (and with the thread's name
    normalised)."""
    mod.probe.reset()
    a, b = mod.make_lock("A"), mod.make_rlock("B")
    cv = mod.make_condition("CV")
    mod.note_io("read_unit")                     # nothing held: no hazard
    with a:
        with b:
            with b:                              # reentrant: no edge
                mod.note_io("read_unit")         # hazard under A and B
        with cv:
            cv.wait(0.0)                         # timed; drops CV
            cv.wait_for(lambda: True)            # no wait at all
    with b:
        with a:                                  # inversion: cycle
            pass
    done = []

    def setter():
        with cv:
            done.append(1)
            cv.notify_all()

    with cv:
        t = threading.Thread(target=setter)
        t.start()
        while not done:
            cv.wait()                            # untimed, released by setter
    t.join()
    rep = mod.probe.report()
    mod.probe.reset()
    locks = {k: {f: v[f] for f in ("acquires",)}
             for k, v in rep["locks"].items()}
    waits = {k: {f: v[f] for f in ("waits", "timed_waits")}
             for k, v in rep["cv_waits"].items()}
    hazards = [dict(h, thread="main" if h["thread"] ==
                    threading.current_thread().name else h["thread"])
               for h in rep["hazards"]]
    return (rep["kind"], rep["edges"], locks, waits, hazards,
            rep["cycles"], sorted(map(sorted, mod.probe.cycles())))


def test_probe_reports_match_reference_on_one_script(monkeypatch):
    monkeypatch.setenv("REPRO_ANALYZE", "1")
    got, want = _probe_script(TLocks), _probe_script(JLocks)
    assert got == want
    kind, edges, locks, waits, hazards, cycles, _ = got
    assert {(e["src"], e["dst"]) for e in edges} == {
        ("A", "B"), ("A", "CV"), ("B", "A")}
    assert locks["A"]["acquires"] == 2 and locks["B"]["acquires"] == 2
    assert waits["CV"]["timed_waits"] == 1 and waits["CV"]["waits"] >= 2
    assert hazards == [{"io": "read_unit", "held": ["A", "B"],
                        "thread": "main"}]
    assert len(cycles) == 1 and set(cycles[0]) == {"A", "B"}
