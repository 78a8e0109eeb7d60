"""The arithmetic of the end-to-end metrics, on the run's raw records:
window rates, tails of all samples, means.  Host times are
``time.monotonic()`` seconds throughout."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Sequence


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q < 1) of all the samples, interpolated
    between order statistics (``statistics.quantiles``' inclusive
    method); None without samples."""
    v = sorted(float(x) for x in values)
    if not v:
        return None
    if len(v) == 1:
        return v[0]
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def mean(values: Iterable[float]) -> Optional[float]:
    v = [float(x) for x in values]
    return statistics.fmean(v) if v else None


def in_window(t: float, t0: float, t1: float) -> bool:
    return t0 <= t < t1


def window_rate(times: Iterable[float], t0: float, t1: float
                ) -> Optional[float]:
    """Events whose time falls in ``[t0, t1)``, per second of the window."""
    if t1 <= t0:
        return None
    return sum(1 for t in times if in_window(t, t0, t1)) / (t1 - t0)


def gaps_ending_in(token_times: Sequence[Sequence[float]], t0: float,
                   t1: float) -> List[float]:
    """Every inter-token gap, of every request, whose later token falls
    in the window."""
    out = []
    for tt in token_times:
        for a, b in zip(tt, tt[1:]):
            if in_window(b, t0, t1):
                out.append(b - a)
    return out
