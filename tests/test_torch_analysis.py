"""The port's concurrency lint (``repro_torch.analysis.lint``): every rule
case of the reference's ``tests/test_analysis.py`` re-aimed at the port's
lint (rules R1-R4; the reference's R5 checks ``jax.jit`` and has nothing to
check in the port), the baseline workflow, and ``src/repro_torch`` itself:
clean modulo its own baseline, an acyclic static lock graph, and the CLI
exiting 0 on both."""
import os
import textwrap

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import lint as L

from torch_testlib import PORT

SRC = str(PORT)
BASELINE = os.path.join(SRC, "analysis", "baseline.txt")


def lint(src, relpath="mod.py"):
    return L.lint_source(textwrap.dedent(src), relpath)


def ids_of(findings):
    return {f.id for f in findings}


# ---------------------------------------------------------------------------
# R1 guarded-by
# ---------------------------------------------------------------------------

def test_r1_fires_on_unlocked_access_and_not_on_locked():
    fs = lint("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0   # guarded-by: _lock

            def good(self):
                with self._lock:
                    self._n += 1

            def bad(self):
                return self._n
    """)
    assert ids_of(fs) == {"R1:mod.py:C.bad:_n"}
    assert fs[0].rule == "R1"


def test_r1_factory_made_lock_and_registry_declaration():
    fs = lint("""
        from repro_torch.analysis import make_lock

        class C:
            _guarded_by = {"_n": "_lock"}

            def __init__(self):
                self._lock = make_lock("C._lock")
                self._n = 0

            def bad(self):
                self._n = 5
    """)
    assert ids_of(fs) == {"R1:mod.py:C.bad:_n"}


def test_r1_writes_mode_checks_mutations_only():
    fs = lint("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.events = []   # guarded-by[writes]: _lock

            def ok_read(self):
                return len(self.events)

            def ok_locked_write(self):
                with self._lock:
                    self.events.append(1)

            def bad_append(self):
                self.events.append(1)

            def bad_setitem(self):
                self.events[0] = 2

            def bad_rebind(self):
                self.events = []
    """)
    assert ids_of(fs) == {"R1:mod.py:C.bad_append:events",
                          "R1:mod.py:C.bad_setitem:events",
                          "R1:mod.py:C.bad_rebind:events"}


def test_r1_skips_locked_suffix_init_and_lambdas():
    fs = lint("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0   # guarded-by: _lock

            def _bump_locked(self):
                self._n += 1          # caller holds the lock: convention

            def deferred(self):
                return lambda: self._n    # runs under unknowable scope
    """)
    assert fs == []


def test_r1_inline_suppression():
    fs = lint("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0   # guarded-by: _lock

            def prepare(self):
                self._n = 0   # analysis: ignore[R1]
    """)
    assert fs == []


# ---------------------------------------------------------------------------
# R2 cv-wait discipline
# ---------------------------------------------------------------------------

R2_SRC = """
    import threading

    class C:
        def __init__(self):
            self._cv = threading.Condition()
            self.ready = False

        def bad_poll(self):
            with self._cv:
                self._cv.wait(0.02)

        def good(self, wait_s):
            with self._cv:
                while not self.ready:
                    self._cv.wait(wait_s)
"""


def test_r2_flags_no_while_and_literal_timeout():
    fs = lint(R2_SRC)
    assert ids_of(fs) == {
        "R2:mod.py:C.bad_poll:_cv.wait-not-in-while",
        "R2:mod.py:C.bad_poll:_cv.wait-literal-timeout-0.02"}
    # the good computed-deadline while-loop wait produced nothing
    assert all("good" not in f.scope for f in fs)


def test_r2_inline_suppression_and_stable_ids_across_line_shift():
    shifted = "\n\n\n" + textwrap.dedent(R2_SRC)
    assert ids_of(lint(R2_SRC)) == ids_of(L.lint_source(shifted, "mod.py"))
    suppressed = R2_SRC.replace("self._cv.wait(0.02)",
                                "self._cv.wait(0.02)  # analysis: ignore[R2]")
    assert lint(suppressed) == []


# ---------------------------------------------------------------------------
# R3 lock order
# ---------------------------------------------------------------------------

def test_r3_cycle_in_nested_with_acquisitions():
    fs = lint("""
        import threading

        class A:
            def __init__(self):
                self._la = threading.Lock()
                self._lb = threading.Lock()

            def one(self):
                with self._la:
                    with self._lb:
                        pass

            def two(self):
                with self._lb:
                    with self._la:
                        pass
    """)
    assert len(fs) == 1 and fs[0].rule == "R3"
    assert "A._la" in fs[0].message and "A._lb" in fs[0].message


def test_r3_edge_via_typed_attribute_call_resolution():
    model = L.FileModel(textwrap.dedent("""
        import threading

        class Inner:
            def __init__(self):
                self._lock = threading.Lock()

            def poke(self):
                with self._lock:
                    pass

        class Outer:
            def __init__(self, inner: Inner):
                self._lock = threading.Lock()
                self.inner = inner

            def call(self):
                with self._lock:
                    self.inner.poke()
    """), "m.py")
    edges, cycles = L.build_static_lockgraph([model])
    assert ("Outer._lock", "Inner._lock") in {(e.src, e.dst) for e in edges}
    assert cycles == []


def test_r3_no_cycle_for_consistent_order():
    fs = lint("""
        import threading

        class A:
            def __init__(self):
                self._la = threading.Lock()
                self._lb = threading.Lock()

            def one(self):
                with self._la:
                    with self._lb:
                        pass

            def two(self):
                with self._la:
                    with self._lb:
                        pass
    """)
    assert fs == []


# ---------------------------------------------------------------------------
# R4 time.sleep
# ---------------------------------------------------------------------------

def test_r4_flags_sleep_and_respects_allowlist():
    src = """
        import time

        def poll():
            time.sleep(0.1)
    """
    fs = lint(src)
    assert ids_of(fs) == {"R4:mod.py:poll:time.sleep"}
    # the simulated storage device is allowed to sleep
    assert lint(src, relpath="store/store.py") == []
    # inline suppression
    assert lint(src.replace("time.sleep(0.1)",
                            "time.sleep(0.1)  # analysis: ignore[R4]")) == []


# ---------------------------------------------------------------------------
# baseline workflow
# ---------------------------------------------------------------------------

def test_baseline_load_apply_and_stale_detection(tmp_path):
    fs = lint(R2_SRC)
    p = tmp_path / "baseline.txt"
    p.write_text(
        "# comment line\n"
        "R2:mod.py:C.bad_poll:_cv.wait-not-in-while  # legacy polling\n"
        "R2:mod.py:C.gone:_cv.wait-not-in-while  # no longer exists\n")
    baseline = L.load_baseline(str(p))
    assert baseline["R2:mod.py:C.bad_poll:_cv.wait-not-in-while"] \
        == "legacy polling"
    unsup, stale = L.apply_baseline(fs, baseline)
    assert ids_of(unsup) == {"R2:mod.py:C.bad_poll:"
                             "_cv.wait-literal-timeout-0.02"}
    assert stale == ["R2:mod.py:C.gone:_cv.wait-not-in-while"]


# ---------------------------------------------------------------------------
# meta: the port itself is clean modulo its own reviewed baseline
# ---------------------------------------------------------------------------

def test_src_repro_torch_clean_modulo_baseline():
    findings = L.lint_paths([SRC])
    baseline = L.load_baseline(BASELINE)
    unsup, stale = L.apply_baseline(findings, baseline)
    assert not unsup, "\n".join(f.render() for f in unsup)
    assert not stale, f"stale baseline entries: {stale}"
    # every entry the baseline holds carries its justification
    assert all(just for just in baseline.values())


def test_src_repro_torch_static_lockgraph_acyclic():
    edges, cycles = L.build_static_lockgraph(L.load_models(SRC))
    assert cycles == []


def test_cli_lint_and_lockgraph_exit_zero_on_the_port(capsys, tmp_path):
    assert cli.main(["lint"]) == 0
    assert "0 blocking" in capsys.readouterr().out
    out = tmp_path / "graph.json"
    assert cli.main(["lockgraph", "--json-out", str(out)]) == 0
    assert "no cycles." in capsys.readouterr().out
    assert out.exists()
    # the defaults are the port's tree and the port's own baseline
    assert cli._default_roots() == [os.path.normpath(SRC)]
    assert cli._default_baseline() == BASELINE
