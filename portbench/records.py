"""Views of a run's records that the readers share."""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Tuple


def window_requests(rec: Dict[str, Any], served: bool = True
                    ) -> List[Dict[str, Any]]:
    """Requests due in the window (sent in it, for a closed loop); with
    ``served``, those that were answered."""
    t0, t1 = rec["t0"], rec["t1"]
    out = [r for r in rec["requests"] if t0 <= r["t_due"] < t1]
    return [r for r in out if r["error"] is None] if served else out


def token_times(rec: Dict[str, Any]) -> List[List[float]]:
    return [r["token_times"] for r in rec["requests"]
            if r["token_times"]]


def decode_steps(rec: Dict[str, Any]) -> List[Tuple[float, int]]:
    """(time, live rows) of each decode step, from the tokens the steps
    emitted: a step stamps every row it advances with one time, and each
    request's first token comes from its prefill."""
    c: Counter = Counter()
    for r in rec["requests"]:
        for t in (r["token_times"] or [])[1:]:
            c[t] += 1
    return sorted(c.items())


def decode_tokens(rec: Dict[str, Any]):
    """(time, position of the token the step took in) of every token a
    decode step emitted."""
    for r in rec["requests"]:
        tt = r["token_times"] or []
        for k in range(1, len(tt)):
            yield tt[k], r["n_prompt"] + k - 1


def traced(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The device trace's summary, or {} without one."""
    return rec.get("trace") or {}


def in_trace(rec: Dict[str, Any], t: Optional[float]) -> bool:
    """Whether host time ``t`` falls in the traced window: the work a
    roofline counts is the work whose result came in there."""
    tr = traced(rec)
    return bool(tr) and t is not None and tr["t0"] <= t < tr["t1"]


def traced_prefills(rec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Requests whose prefill (their first token) came in the traced
    window."""
    return [r for r in rec["requests"]
            if r["error"] is None and in_trace(rec, r["t_first"])]
