"""The benchmark's own spans around its calls into the program's layers.

A span is (name, thread, start, end) on ``time.monotonic()``.  Spans
around the benchmark's own calls are also ``torch.profiler``
``record_function`` ranges, so a traced run's timeline carries them; the
phases of each request are added from its record once the window has
closed.  Spans stay in memory; the traced run labels the device's idle
gaps by the spans open across them."""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function
        t0 = time.monotonic()
        try:
            with record_function(f"portbench.{name}"):
                yield
        finally:
            t1 = time.monotonic()
            with self._lock:
                self.items.append((name, threading.get_ident(), t0, t1))

    def add(self, name: str, t0: Optional[float], t1: Optional[float]):
        if t0 is not None and t1 is not None and t1 > t0:
            with self._lock:
                self.items.append((name, 0, t0, t1))

    def add_request_phases(self, requests) -> None:
        """Each request's phases from its record: ``queued`` (due to
        service start), ``to_first_token`` (service start to the first
        token: a prefill, or a cold start and its prefill) and
        ``decoding`` (to the last token)."""
        for r in requests:
            tt = r.get("token_times") or []
            self.add("queued", r["t_due"], r["t_start"])
            self.add("to_first_token", r["t_start"], r["t_first"])
            self.add("decoding", r["t_first"], tt[-1] if tt else None)

    def open_at(self, t: float) -> List[str]:
        with self._lock:
            return sorted({n for n, _, a, b in self.items if a <= t < b})
