"""The metric arithmetic on hand-made records: a window rate, a 95th
percentile of all samples, a stall that moves the tail, and the
per-layer readers."""
import statistics

import pytest

from portbench import stats
from portbench.end_to_end import cold_ttft_ms, tpot_p95_ms, ttft_p95_ms
from portbench.layer_metrics import (idle_pct, load_x_floor,
                                     pipeline_util, queue_ms, step_ms,
                                     tokens_per_step)


def req(i, t_due, t_first, gaps, n_prompt=10, **kw):
    times = [t_first]
    for g in gaps:
        times.append(times[-1] + g)
    r = {"id": i, "t_due": t_due, "t_submit": t_due, "t_first": t_first,
         "token_times": times, "tokens": list(range(len(times))),
         "n_prompt": n_prompt, "error": None, "cold": True, "load_s": None,
         "utilization": None, "queue_s": None, "ttft_s": None}
    r.update(kw)
    return r


def test_quantile_matches_statistics():
    v = [5.0, 1.0, 3.0, 2.0, 4.0, 9.0, 7.0]
    assert stats.quantile(v, 0.5) == statistics.median(v)
    assert stats.quantile(v, 0.25) == statistics.quantiles(
        v, n=4, method="inclusive")[0]
    assert stats.quantile([], 0.95) is None
    assert stats.quantile([3.0], 0.95) == 3.0


def test_p95_of_all_samples():
    v = list(range(1, 101))
    assert stats.quantile(v, 0.95) == pytest.approx(95.05)


def test_window_rate():
    assert stats.window_rate([0.5, 1.0, 1.5, 2.0, 9.0], 0.0, 2.0) == 1.5
    assert stats.window_rate([1.0], 2.0, 2.0) is None


def test_preroll_requests_are_not_the_windows():
    """Requests due before the window (an open loop's pre-roll) are left
    out of its TTFT tail; their gaps that end in it stay in its TPOT."""
    rs = [req(0, -5.0, 9.0, [0.5, 0.5]),
          req(1, 0.0, 0.2, [0.1, 0.1]), req(2, 1.0, 1.2, [0.1])]
    rec = {"t0": 0.0, "t1": 20.0, "requests": rs}
    assert ttft_p95_ms.read(rec) == pytest.approx(200.0)
    assert tpot_p95_ms.read(rec) == pytest.approx(
        1e3 * stats.quantile([0.5, 0.5, 0.1, 0.1, 0.1], 0.95))


def test_stall_moves_the_tail():
    """80 gaps of 0.1 s: one stall of 1 s (1.25% of them) leaves the
    p95 of all gaps alone, eight (10%) move it to the stall."""
    def rec(stalls):
        rs = []
        for i in range(4):
            gaps = [0.1] * 20
            for j in range(stalls):
                gaps[5 + j] = 1.0
            rs.append(req(i, 0.0, 0.0, gaps))
        return {"t0": 0.0, "t1": 60.0, "requests": rs}
    assert tpot_p95_ms.read(rec(0)) == pytest.approx(100.0)
    one = rec(0)
    one["requests"][0]["token_times"][9:] = [
        t + 0.9 for t in one["requests"][0]["token_times"][9:]]
    assert tpot_p95_ms.read(one) == pytest.approx(100.0)
    assert tpot_p95_ms.read(rec(2)) == pytest.approx(1000.0)


def test_ttft_from_due_time():
    """An open loop's TTFT starts at the due time, so a request sent late
    behind a stall is charged its wait."""
    rs = [req(i, float(i), float(i) + 0.2, []) for i in range(19)]
    rs.append(req(19, 19.0, 21.0, []))
    rec = {"t0": 0.0, "t1": 20.0, "requests": rs}
    v = ttft_p95_ms.read(rec)
    assert 200.0 < v < 2000.0
    assert v == pytest.approx(1e3 * stats.quantile(
        [0.2] * 19 + [2.0], 0.95))


def test_cold_means():
    rs = [req(i, float(i), float(i) + 2.0, [0.1], load_s=1.0 + i,
              utilization=0.5, queue_s=0.01) for i in range(3)]
    rec = {"t0": 0.0, "t1": 3.0, "requests": rs,
           "store": {"bytes": 2_000_000_000, "mbps": 2000}}
    assert cold_ttft_ms.read(rec) == pytest.approx(2000.0)
    assert load_x_floor.read(rec) == pytest.approx(2.0)
    assert pipeline_util.read(rec) == pytest.approx(50.0)
    assert queue_ms.read(rec) == pytest.approx(10.0)


def test_steps_and_idle():
    rs = [req(0, 0.0, 0.1, [0.1] * 9), req(1, 0.0, 0.1, [0.1] * 4)]
    rec = {"t0": 0.0, "t1": 2.0, "requests": rs, "steps": 20}
    assert step_ms.read(rec) == pytest.approx(100.0)
    assert tokens_per_step.read(rec) == pytest.approx(13 / 20)
    assert idle_pct.read(rec) is None
    rec["trace"] = {"busy_s": 0.5, "window_s": 2.0, "t0": 0.0, "t1": 2.0}
    assert idle_pct.read(rec) == pytest.approx(75.0)
