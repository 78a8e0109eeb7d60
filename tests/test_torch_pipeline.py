"""The port's Priority-Aware Scheduler (Algorithm 1) and pipeline trace
against the JAX package's: the same scripted stream events give the same
decisions and gate states, and the same stage events give the same
utilization, waits, memory metrics and Gantt chart."""
import time

import pytest

from repro.core import pipeline as jpipeline
from repro.core import scheduler as jscheduler
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import scheduler as tscheduler


def _gates(streams):
    return {u: st.gate.is_set() for u, st in streams.items()}


def late_critical(mod):
    """W0 is past its expected completion: the others are suspended
    until it completes."""
    s = mod.PriorityAwareScheduler(bw_bytes_per_s=1e12, a_overhead_s=0.0)
    streams = {u: s.register(u, 10) for u in ("w0", "w1", "w2")}
    for u in streams:
        s.on_issue(u)
    time.sleep(0.01)
    out = [s.adjust_priority("w0"), _gates(streams), s.suspend_count,
           s.time_until_expected("w0")]
    s.on_complete("w0")
    return out + [_gates(streams), s.adjust_priority("w0")]


def on_time(mod):
    """A stream before its expected completion stays NORMAL and arms a
    deadline; an unissued one arms none."""
    s = mod.PriorityAwareScheduler(bw_bytes_per_s=1e9)
    s.register("w0", 10 ** 9)
    s.register("w1", 10 ** 9)
    s.on_issue("w0")
    wait = s.time_until_expected("w0")
    return [s.adjust_priority("w0"), s.suspend_count, 0.5 < wait <= 1.001,
            s.time_until_expected("w1"), s.adjust_priority("w1")]


def disabled(mod):
    s = mod.PriorityAwareScheduler(bw_bytes_per_s=1e12, enabled=False)
    streams = {u: s.register(u, 10) for u in ("w0", "w1")}
    s.on_issue("w0")
    time.sleep(0.01)
    return [s.adjust_priority("w0"), s.time_until_expected("w0"),
            _gates(streams), s.suspend_count]


def error_lifts_suspension(mod):
    """A failed critical stream un-parks every suspended stream."""
    s = mod.PriorityAwareScheduler(bw_bytes_per_s=1e12, a_overhead_s=0.0)
    streams = {u: s.register(u, 10) for u in ("w0", "w1")}
    for u in streams:
        s.on_issue(u)
    time.sleep(0.01)
    out = [s.adjust_priority("w1"), _gates(streams)]
    s.on_error("w1")
    return out + [_gates(streams), s.adjust_priority("w1"),
                  s.adjust_priority("w0")]


def sharded_streams(mod):
    """Streams keyed (unit, shard): one late shard makes its unit
    critical and parks every other unit's shards; the unit's deadline is
    the max over its in-flight shards; the others resume when the unit's
    last shard completes, and a failed shard lifts every suspension."""
    s = mod.PriorityAwareScheduler(bw_bytes_per_s=1e12, a_overhead_s=0.0)
    streams = {(u, k): s.register(u, 10 * (k + 1), shard=k)
               for u, n in (("w0", 3), ("w1", 2)) for k in range(n)}

    def gates():
        return {f"{u}/{k}": st.gate.is_set()
                for (u, k), st in streams.items()}
    for u, k in streams:
        s.on_issue(u, shard=k)
    time.sleep(0.01)
    order = s.expected_completion("w0", 2) > s.expected_completion("w0", 0)
    out = [order, s.adjust_priority("w0"), gates(), s.suspend_count,
           s.time_until_expected("w0")]
    s.on_complete("w0", shard=0)
    s.on_complete("w0", shard=1)
    out += [gates(), s.time_until_expected("w1") is not None]
    s.on_complete("w0", shard=2)
    out += [gates(), s.adjust_priority("w1"), gates()]
    s.on_error("w1", shard=0)
    return out + [gates(), s.adjust_priority("w1")]


@pytest.mark.parametrize("scenario", [late_critical, on_time, disabled,
                                      error_lifts_suspension,
                                      sharded_streams],
                         ids=lambda f: f.__name__)
def test_algorithm1_matches_reference(scenario):
    assert scenario(tscheduler) == scenario(jscheduler)


EVENTS = [("L", "embed", 0.0, 0.5), ("R", "embed", 0.0, 2.0),
          ("L", "block_000", 0.5, 1.0), ("R", "block_000", 0.2, 2.5),
          ("A", "embed", 2.0, 2.2), ("E", "embed", 2.3, 2.4),
          ("A", "block_000", 2.5, 3.0), ("E", "block_000", 3.5, 4.0),
          ("T", "block_000", 2.4, 2.6, {"shard": 1})]
MEMORY = [("embed", 1000, 0.5, 2.2), ("block_000", 500, 1.0, 3.0)]


def _trace(mod):
    tr = mod.PipelineTrace()
    tr.t0 = 0.0
    for ev in EVENTS:
        tr.add_event(*ev)
    for m in MEMORY:
        tr.record_memory(*m)
    tr.t_end = 4.5
    return tr


def test_trace_metrics_match_reference():
    t, j = _trace(tpipeline), _trace(jpipeline)
    want = j.summary()
    assert want["work_T"] == pytest.approx(0.2)     # the shard stage
    assert t.summary() == pytest.approx(want)
    assert t.render_gantt(60) == j.render_gantt(60)
    assert t.busy_time(None) == pytest.approx(j.busy_time(None))
