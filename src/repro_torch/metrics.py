"""Live metrics surface: thread-safe counter / gauge / histogram registry,
a port of ``repro.metrics``.

One :class:`MetricsRegistry` per platform (or the process default) holds
named instruments that the serving stack updates in place:

  * **Counter** — monotone event counts (``decode/steps``,
    ``decode/joined``, ``kv/prefix_hits``);
  * **Gauge** — point-in-time levels with a high-water mark
    (``decode/occupancy``, ``kv/pages_used``);
  * **Histogram** — fixed log-spaced buckets + exact count/sum/min/max,
    with interpolated quantiles.

Every instrument takes its lock from :mod:`repro_torch.analysis`.
Instrument locks are *leaf* locks: no instrument method acquires any
other lock, so a component may update metrics while holding its own CV.
:meth:`MetricsRegistry.snapshot` renders everything as one
JSON-serializable dict.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch import analysis

# Default histogram bounds: log-spaced seconds from 1 ms to 60 s —
# covers a warm TTFT (~ms) through a bandwidth-starved cold start
# (~seconds) in the same instrument.  The terminal +inf bucket catches
# outliers so count bookkeeping is exact.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf)


class Counter:
    """Monotone event counter."""

    def __init__(self, name: str):
        self.name = name
        self._lock = analysis.make_lock("metrics.Counter._lock")
        self._value = 0.0                       # guarded-by: _lock

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> float:
        return self.value


class Gauge:
    """Point-in-time level + its high-water mark since creation."""

    def __init__(self, name: str):
        self.name = name
        self._lock = analysis.make_lock("metrics.Gauge._lock")
        self._value = 0.0                       # guarded-by: _lock
        self._max = 0.0                         # guarded-by: _lock

    def set(self, v: float):
        with self._lock:
            self._value = float(v)
            self._max = max(self._max, self._value)

    def add(self, d: float):
        with self._lock:
            self._value += d
            self._max = max(self._max, self._value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def render(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value, "max": self._max}


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    interpolated quantiles.

    Buckets are cumulative-upper-bound style (``le``); the last bound
    must be +inf so every observation lands somewhere.  Quantiles
    interpolate linearly within the containing bucket (clamped to the
    observed min/max, so a single observation reports itself exactly).
    """

    def __init__(self, name: str,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self.bounds = bounds
        self._lock = analysis.make_lock("metrics.Histogram._lock")
        self._counts = [0] * len(bounds)        # guarded-by: _lock
        self._count = 0                         # guarded-by: _lock
        self._sum = 0.0                         # guarded-by: _lock
        self._min = math.inf                    # guarded-by: _lock
        self._max = -math.inf                   # guarded-by: _lock

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (q in [0, 1]); NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return math.nan
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else self._min
            hi = self.bounds[i]
            lo = max(lo, self._min)
            hi = min(hi, self._max)
            if cum + c >= rank:
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self._max

    def render(self) -> Dict[str, object]:
        with self._lock:
            empty = self._count == 0
            return {
                "count": self._count,
                "sum": self._sum,
                "min": None if empty else self._min,
                "max": None if empty else self._max,
                "p50": None if empty else self._quantile_locked(0.50),
                "p90": None if empty else self._quantile_locked(0.90),
                "p99": None if empty else self._quantile_locked(0.99),
                "buckets": [[b, c] for b, c in
                            zip(self.bounds, self._counts) if c],
            }


class MetricsRegistry:
    """Create-or-get registry of named instruments.

    Thread-safe: the registry lock guards only the name->instrument
    dict (instrument creation); per-instrument updates take the
    instrument's own leaf lock.  Asking for an existing name with a
    different instrument type raises — one name, one meaning.
    """

    def __init__(self):
        self._lock = analysis.make_lock("MetricsRegistry._lock")
        self._instruments: Dict[str, object] = {}   # guarded-by: _lock

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is a {type(inst).__name__}, "
                f"not a {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, object]:
        """One JSON-serializable dict of every instrument — the
        scrapeable surface.  Values are read per-instrument (each under
        its own lock): the snapshot is per-instrument consistent, not a
        global atomic cut, which is the standard scrape contract."""
        with self._lock:
            items = sorted(self._instruments.items())
        out: Dict[str, object] = {"ts_monotonic": time.monotonic(),
                                  "counters": {}, "gauges": {},
                                  "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.render()
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.render()
            else:
                out["histograms"][name] = inst.render()
        return out

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)


# ---------------------------------------------------------------------------
# process default — components constructed outside a platform record here
# ---------------------------------------------------------------------------

_default: Optional[MetricsRegistry] = None
_default_lock = analysis.make_lock("metrics._default_lock")


def default_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use).
    Components accept ``metrics=None`` and fall back here, so
    standalone schedulers and page pools still record; a caller that
    wants its snapshot isolated passes a registry of its own."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def resolve(metrics: Optional[MetricsRegistry]) -> MetricsRegistry:
    """``metrics`` or the process default."""
    return metrics if metrics is not None else default_registry()
