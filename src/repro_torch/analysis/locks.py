"""Instrumented lock factory + runtime concurrency probe (a port of
``repro.analysis.locks``).

Every ``repro_torch`` module obtains its synchronization primitives from
this factory (:func:`make_lock` / :func:`make_rlock` /
:func:`make_condition`) instead of calling ``threading.Lock()`` directly.
In normal operation the factory returns the plain ``threading`` objects —
zero overhead, no behavior change.  With ``REPRO_ANALYZE=1`` in the
environment it returns instrumented wrappers that feed one process-global
:class:`Probe`:

  * **per-thread held-lock sets** — every acquire/release maintains the
    acquiring thread's stack of held locks (reentrant acquires counted,
    condition waits correctly *drop* the lock for their duration);
  * **observed acquisition-order graph** — acquiring B while holding A
    records the edge ``A -> B``; a cycle in this graph is a real
    lock-order inversion observed at runtime (deadlock hazard even if
    this particular run got lucky with timing);
  * **wait / hold durations** — per lock: acquire count, contended-wait
    time and max, hold time and max — the data behind the
    lock-hotspot report;
  * **condition-wait discipline** — counts of ``Condition.wait`` calls
    and how many passed a timeout (the event-driven pipeline should
    show ~zero *polling* timeouts; Algorithm-1 deadline wakes are the
    intended exceptions);
  * **lock-held-across-I/O hazards** — the store's read path calls
    :func:`note_io`; reaching one with any instrumented lock held means
    a lock is pinned across device I/O, serializing every sibling
    stream behind one read.

Only primitives made while the switch is on are instrumented: locks made
at import time (``metrics._default_lock``, ``kernels.cuda_lib``'s module
lock and the kernels' ``LaunchCounter`` locks, made when the kernel
registry is imported) stay plain when the switch is set later, and the
probe does not see them.

The probe's :meth:`Probe.report` snapshot merges with the static
lock-order graph via ``python -m repro_torch.analysis lockgraph
--observed``; set ``REPRO_ANALYZE_OUT=<path>`` to dump the JSON artifact
at process exit.

The switches are the reference's own (``REPRO_ANALYZE``,
``REPRO_ANALYZE_OUT``), so one setting instruments both packages in a
process that imports both (the tests).  Each package keeps its own
:data:`probe` and sees only its own primitives.  If both packages dump
to one ``REPRO_ANALYZE_OUT`` path, each overwrites the file: ``atexit``
runs its handlers in reverse order of registration, so the file ends up
holding the report of the package whose ``analysis.locks`` module was
imported *first*.  Dump each package's probe with :meth:`Probe.dump` to
a path of its own when both are wanted.

The probe's own internal mutex is a *plain* ``threading.Lock`` and is
never self-instrumented.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


def enabled() -> bool:
    """True when the instrumented wrappers are active (REPRO_ANALYZE=1).

    Checked at primitive *construction* time: objects created while
    disabled stay plain, objects created while enabled stay
    instrumented — flipping the env var mid-process affects only locks
    created afterwards (tests construct their subjects after setting
    it)."""
    return os.environ.get("REPRO_ANALYZE", "") not in ("", "0")


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

class _Held:
    __slots__ = ("name", "t_acquired", "count")

    def __init__(self, name: str, t_acquired: float):
        self.name = name
        self.t_acquired = t_acquired
        self.count = 1


class Probe:
    """Process-global recorder behind every instrumented primitive."""

    def __init__(self):
        self._mu = threading.Lock()          # internal; never instrumented
        self._tls = threading.local()
        self.reset()

    # ------------------------------------------------------------- lifecycle
    def reset(self):
        with self._mu:
            # (holder, acquired) -> times observed nested
            self.edges: Dict[Tuple[str, str], int] = {}
            # name -> {acquires, contended, wait_s, wait_max_s,
            #          hold_s, hold_max_s}
            self.locks: Dict[str, Dict[str, float]] = {}
            # name -> {waits, timed_waits, wait_s}
            self.cv_waits: Dict[str, Dict[str, float]] = {}
            # list of {"io": tag, "held": [...], "thread": name}
            self.hazards: List[Dict[str, Any]] = []
            self._cycles: List[List[str]] = []

    def _held(self) -> List[_Held]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    # ------------------------------------------------------------ recording
    def _lock_rec(self, name: str) -> Dict[str, float]:
        rec = self.locks.get(name)
        if rec is None:
            rec = self.locks[name] = {
                "acquires": 0, "contended": 0, "wait_s": 0.0,
                "wait_max_s": 0.0, "hold_s": 0.0, "hold_max_s": 0.0}
        return rec

    def on_acquired(self, name: str, wait_s: float, contended: bool):
        """Called by a wrapper after its raw acquire succeeded."""
        held = self._held()
        for h in held:
            if h.name == name:               # reentrant re-acquire
                h.count += 1
                return
        now = time.monotonic()
        with self._mu:
            rec = self._lock_rec(name)
            rec["acquires"] += 1
            rec["wait_s"] += wait_s
            rec["wait_max_s"] = max(rec["wait_max_s"], wait_s)
            if contended:
                rec["contended"] += 1
            for h in held:
                if h.name != name:
                    self._add_edge_locked(h.name, name)
        held.append(_Held(name, now))

    def on_released(self, name: str):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].name == name:
                held[i].count -= 1
                if held[i].count == 0:
                    h = held.pop(i)
                    dur = time.monotonic() - h.t_acquired
                    with self._mu:
                        rec = self._lock_rec(name)
                        rec["hold_s"] += dur
                        rec["hold_max_s"] = max(rec["hold_max_s"], dur)
                return
        # release of a lock this thread never recorded (e.g. handed
        # across threads) — count nothing rather than corrupt the stack

    def suspend_held(self, name: str) -> Optional[_Held]:
        """A Condition.wait is releasing ``name``: take it off the held
        stack for the wait's duration (charging the hold so far)."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].name == name:
                h = held.pop(i)
                dur = time.monotonic() - h.t_acquired
                with self._mu:
                    rec = self._lock_rec(name)
                    rec["hold_s"] += dur
                    rec["hold_max_s"] = max(rec["hold_max_s"], dur)
                return h
        return None

    def resume_held(self, h: Optional[_Held]):
        if h is not None:
            h.t_acquired = time.monotonic()
            self._held().append(h)

    def on_cv_wait(self, name: str, timeout: Optional[float],
                   waited_s: float):
        with self._mu:
            rec = self.cv_waits.get(name)
            if rec is None:
                rec = self.cv_waits[name] = {
                    "waits": 0, "timed_waits": 0, "wait_s": 0.0}
            rec["waits"] += 1
            rec["wait_s"] += waited_s
            if timeout is not None:
                rec["timed_waits"] += 1

    def note_io(self, tag: str):
        """An I/O region was entered; any held instrumented lock is a
        lock-held-across-I/O hazard."""
        held = [h.name for h in self._held()]
        if not held:
            return
        with self._mu:
            entry = {"io": tag, "held": held,
                     "thread": threading.current_thread().name}
            if not any(hz["io"] == tag and hz["held"] == held
                       for hz in self.hazards):
                self.hazards.append(entry)

    # ---------------------------------------------------------- cycle check
    def _add_edge_locked(self, a: str, b: str):
        key = (a, b)
        fresh = key not in self.edges
        self.edges[key] = self.edges.get(key, 0) + 1
        if fresh:
            cyc = find_cycle({k for k in self.edges}, start=b, target=a)
            if cyc is not None:
                self._cycles.append([a] + cyc)

    def cycles(self) -> List[List[str]]:
        with self._mu:
            return [list(c) for c in self._cycles]

    # -------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """JSON-able snapshot: the observed half of the lockgraph
        artifact."""
        with self._mu:
            return {
                "kind": "repro-analysis-observed",
                "edges": [{"src": a, "dst": b, "count": n}
                          for (a, b), n in sorted(self.edges.items())],
                "locks": {k: dict(v)
                          for k, v in sorted(self.locks.items())},
                "cv_waits": {k: dict(v)
                             for k, v in sorted(self.cv_waits.items())},
                "hazards": [dict(h) for h in self.hazards],
                "cycles": [list(c) for c in self._cycles],
            }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2, sort_keys=True)


def find_cycle(edges, start: str, target: str) -> Optional[List[str]]:
    """DFS path ``start -> ... -> target`` over directed ``edges``
    (iterable of (a, b)); returns the node path including both ends, or
    None.  Adding edge target->start therefore closes a cycle iff this
    returns a path."""
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == target:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in adj.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


probe = Probe()


def note_io(tag: str):
    """Module-level hook for I/O call sites (no-op when disabled)."""
    if enabled():
        probe.note_io(tag)


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------

class _InstrumentedLock:
    """threading.Lock with probe bookkeeping (non-reentrant)."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._raw = self._make_raw()

    @staticmethod
    def _make_raw():
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.monotonic()
        contended = not self._raw.acquire(False)
        ok = True
        if contended:
            if not blocking:
                return False
            ok = self._raw.acquire(True, timeout)
        if ok:
            probe.on_acquired(self.name, time.monotonic() - t0, contended)
        return ok

    def release(self):
        probe.on_released(self.name)
        self._raw.release()

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _InstrumentedRLock(_InstrumentedLock):
    _reentrant = True

    @staticmethod
    def _make_raw():
        return threading.RLock()


class _InstrumentedCondition:
    """Condition over an instrumented RLock.

    Composes a plain ``threading.Condition`` sharing the *raw* inner
    lock, so wait/notify semantics are stock; the wrapper only keeps
    the probe's held-stack honest — in particular a waiter's lock is
    *suspended* (not held) for the duration of the wait.
    """

    def __init__(self, name: str,
                 lock: Optional[_InstrumentedRLock] = None):
        self.name = name
        self._ilock = lock if lock is not None else _InstrumentedRLock(name)
        self._cond = threading.Condition(self._ilock._raw)

    # lock protocol ------------------------------------------------------
    def acquire(self, *a, **kw):
        return self._ilock.acquire(*a, **kw)

    def release(self):
        self._ilock.release()

    def __enter__(self):
        self._ilock.acquire()
        return self

    def __exit__(self, *exc):
        self._ilock.release()
        return False

    # condition protocol -------------------------------------------------
    def wait(self, timeout: Optional[float] = None):
        t0 = time.monotonic()
        saved = probe.suspend_held(self.name)
        try:
            # primitive layer: the while-predicate loop lives at every
            # call site, which R2 checks there
            return self._cond.wait(timeout)  # analysis: ignore[R2]
        finally:
            probe.resume_held(saved)
            probe.on_cv_wait(self.name, timeout, time.monotonic() - t0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # stock implementation in terms of our wait(), so every
        # underlying wait is recorded
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def make_lock(name: str) -> Any:
    """A mutex for ``name`` (e.g. ``"KernelRegistry._lock"``): plain
    ``threading.Lock`` normally, instrumented under REPRO_ANALYZE=1."""
    return _InstrumentedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str) -> Any:
    return _InstrumentedRLock(name) if enabled() else threading.RLock()


def make_condition(name: str, lock: Any = None) -> Any:
    """A condition variable for ``name``.  ``lock`` (optional) must come
    from this factory too when instrumenting."""
    if enabled():
        ilock = lock if isinstance(lock, _InstrumentedRLock) else None
        return _InstrumentedCondition(name, ilock)
    return threading.Condition(lock)


# ---------------------------------------------------------------------------
# artifact dump at exit
# ---------------------------------------------------------------------------

def _dump_at_exit():          # pragma: no cover - exercised by CI job
    out = os.environ.get("REPRO_ANALYZE_OUT")
    if out and enabled():
        try:
            probe.dump(out)
        except OSError:
            pass


atexit.register(_dump_at_exit)
