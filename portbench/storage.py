"""The benchmark's simulated storage device: a frozen copy of the port's
``BandwidthModel`` (``repro_torch/store/store.py``), handed to
``WeightStore(root, device=...)`` so that the simulated store is part of
the yardstick and a change to the program cannot move it.

Each channel is one token bucket: a chunk of ``n`` bytes holds its
channel for ``n / bandwidth`` seconds, and a reader sleeps until its chunk
has passed.  The bytes are still read from the file underneath.  On top of
the original this copy counts the bytes it served (:attr:`bytes_served`),
so a run can tell that every cold start read the whole store.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class StoreDevice:
    """Per-request latency plus a shared bandwidth cap per channel."""

    def __init__(self, bandwidth_mbps: float = 0.0, latency_ms: float = 0.0,
                 channels: int = 1):
        self.bandwidth_mbps = float(bandwidth_mbps)
        self.latency_ms = float(latency_ms)
        self.channels = max(1, int(channels))
        self._lock = threading.Lock()
        self._next_free = [0.0] * self.channels
        self.bytes_served = 0
        self.opens = 0

    def on_open(self):
        with self._lock:
            self.opens += 1
        if self.latency_ms > 0:
            time.sleep(self.latency_ms / 1e3)

    def on_chunk(self, nbytes: int, channel: int = 0):
        with self._lock:
            self.bytes_served += int(nbytes)
        if self.bandwidth_mbps <= 0:
            return
        dur = nbytes / (self.bandwidth_mbps * 1e6)
        with self._lock:
            ch = channel % self.channels
            start = max(time.monotonic(), self._next_free[ch])
            self._next_free[ch] = start + dur
        delay = (start + dur) - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    def charge(self, nbytes: int, *, channel: int = 0,
               chunk_bytes: int = 1 << 20,
               gate: Optional[threading.Event] = None,
               on_chunk: Optional[Callable[[int], None]] = None):
        done, total = 0, max(0, int(nbytes))
        while done < total:
            if gate is not None:
                gate.wait()
            n = min(int(chunk_bytes), total - done)
            self.on_chunk(n, channel)
            done += n
            if on_chunk is not None:
                on_chunk(n)
