"""SLO-driven autoscaling: pre-provision warm instances from live signals
(a port of ``repro.serving.autoscale``).

The platform's cold-start pipeline makes one cold start as cheap as the
hardware allows, but a 10x arrival burst against a scaled-in pool still
pays that pipeline once per new instance — *on the request path*, where
it lands straight in p99 TTFT.  Production serverless closes the loop
instead: arrival-rate slope and queue depth drive **pre-provisioning**
(λScale's fast scale-out regime), so the burst finds instances already
warm, and idle capacity is scaled back in to free the node.

:class:`Autoscaler` is that policy object — beside
:class:`~repro_torch.serving.policy.EvictionPolicy`, which answers the
per-instance question "may this idle instance be reclaimed?", the
autoscaler answers the pool-level question "how many instances should
be warm *right now*?":

  * every admitted request is observed (the Router calls
    :meth:`observe`); a sliding window keeps per-model arrival times;
  * the **rate estimate** splits the window in half: the older half
    gives the base rate, the newer half minus the older gives the
    slope.  The decision rate is ``recent + max(0, slope) * horizon`` —
    a rising ramp is extrapolated ``horizon_s`` ahead (one cold-start
    latency: provisioning started now must finish before the load
    arrives), a falling one is not chased down;
  * the target warm count is ``ceil(rate / rps_per_instance)`` clamped
    to ``[min_warm, pool.max_instances]``, plus the router queue depth
    term: a backlog deeper than ``queue_per_instance`` per warm
    instance adds capacity even when the rate estimate lags;
  * **scale-out** dispatches :meth:`~repro_torch.serving.pool.InstancePool.
    prewarm` jobs on a private worker pool — the cold-start pipeline
    runs *off* the request path, and duplicate dispatch is suppressed
    while a prewarm is in flight;
  * **scale-in** reclaims idle instances above target via
    :meth:`~repro_torch.serving.pool.InstancePool.scale_in` once a model has
    been idle ``idle_scale_in_s``; busy instances and instances with
    resident generations are structurally out of reach (the pool only
    offers *idle* ones), so a long generation is never yanked.

Driving: call :meth:`tick` from your own loop (tests, logical-clock
replay), or :meth:`start` a background thread that ticks every
``interval_s`` (the SLO benchmark's mode).  All decision inputs can be
passed an explicit ``now`` so unit tests run on a logical clock.

On the GPU a prewarm's cold start runs on one of the autoscaler's worker
threads with the pool's device current; the load brings its own CUDA
streams and waits for them before the instance goes back to the pool, as
it does on a router worker.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, Optional

import torch

from repro_torch import analysis, metrics as metrics_mod


class Autoscaler:
    """Arrival-rate + queue-depth driven warm-capacity controller."""

    def __init__(self, pools: Dict[str, "object"], *,
                 rps_per_instance: float = 2.0,
                 window_s: float = 10.0,
                 horizon_s: float = 5.0,
                 min_warm: int = 0,
                 queue_per_instance: int = 4,
                 idle_scale_in_s: float = 30.0,
                 interval_s: float = 0.5,
                 max_prewarm_workers: int = 2,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None):
        """pools: model -> InstancePool (a ServerlessPlatform's
        ``.pools`` dict works as-is).

        rps_per_instance: serving capacity one warm instance is
        budgeted for — the knob that converts a rate into a count.
        window_s / horizon_s: sliding estimation window and how far a
        rising slope is extrapolated (set horizon to ~one cold-start
        latency so prewarms land before the load does).
        queue_per_instance: router backlog tolerated per warm instance
        before the queue term adds capacity (0 disables the term).
        idle_scale_in_s: no arrivals for this long -> scale the model
        back to min_warm.
        interval_s: background tick period (:meth:`start`).
        """
        if rps_per_instance <= 0:
            raise ValueError("rps_per_instance must be > 0")
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.pools = pools
        self.rps_per_instance = float(rps_per_instance)
        self.window_s = float(window_s)
        self.horizon_s = float(horizon_s)
        self.min_warm = int(min_warm)
        self.queue_per_instance = int(queue_per_instance)
        self.idle_scale_in_s = float(idle_scale_in_s)
        self.interval_s = float(interval_s)
        self.metrics = metrics_mod.resolve(metrics)
        self.router = None          # attached by the platform's Router
        self._cv = analysis.make_condition("Autoscaler._cv")
        self._arrivals: Dict[str, Deque[float]] = {}   # guarded-by: _cv
        self._inflight: Dict[str, int] = {}            # guarded-by: _cv
        self._stop = False                             # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, max_prewarm_workers),
            thread_name_prefix="autoscale-prewarm")

    # -------------------------------------------------------------- signals
    def observe(self, model: str, now: Optional[float] = None):
        """Record one admitted request (called by the Router on every
        submit; cheap — append + trim under the autoscaler lock)."""
        t = time.monotonic() if now is None else now
        with self._cv:
            dq = self._arrivals.get(model)
            if dq is None:
                dq = self._arrivals[model] = deque()
            dq.append(t)
            self._trim_locked(dq, t)
        self.metrics.counter("autoscaler/observed").inc()

    def _trim_locked(self, dq: Deque[float], now: float):
        horizon = now - self.window_s
        while dq and dq[0] < horizon:
            dq.popleft()

    def rate_estimate(self, model: str,
                      now: Optional[float] = None) -> float:
        """Decision rate (req/s): recent-half rate plus the positive
        slope extrapolated ``horizon_s`` ahead."""
        t = time.monotonic() if now is None else now
        with self._cv:
            dq = self._arrivals.get(model)
            if not dq:
                return 0.0
            self._trim_locked(dq, t)
            half = self.window_s / 2.0
            mid = t - half
            n_new = sum(1 for a in dq if a >= mid)
            n_old = len(dq) - n_new
        r_new = n_new / half
        r_old = n_old / half
        slope = (r_new - r_old) / half          # req/s per s
        return r_new + max(0.0, slope) * self.horizon_s

    def target_warm(self, model: str, now: Optional[float] = None) -> int:
        """Warm-instance target for ``model`` right now."""
        pool = self.pools[model]
        rate = self.rate_estimate(model, now)
        target = math.ceil(rate / self.rps_per_instance) if rate > 0 else 0
        if self.queue_per_instance > 0 and self.router is not None:
            depth = self.router.queue_depth()
            st = pool.stats()
            allowance = self.queue_per_instance * max(1, st.live)
            if depth > allowance:
                target += math.ceil(
                    (depth - allowance) / self.queue_per_instance)
        return max(self.min_warm,
                   min(int(target), pool.max_instances))

    # ------------------------------------------------------------ decisions
    def tick(self, now: Optional[float] = None) -> Dict[str, int]:
        """One control-loop iteration over every pool.  Returns
        {model: warm target} (observability / tests).  Scale-out work is
        dispatched asynchronously; scale-in is immediate (eviction is
        cheap and only ever touches idle instances)."""
        t = time.monotonic() if now is None else now
        targets: Dict[str, int] = {}
        for model, pool in self.pools.items():
            target = self.target_warm(model, t)
            targets[model] = target
            st = pool.stats()
            self.metrics.gauge(f"autoscaler/{model}/target").set(target)
            with self._cv:
                inflight = self._inflight.get(model, 0)
                dq = self._arrivals.get(model)
                last_arrival = dq[-1] if dq else None
            deficit = target - st.live - inflight
            if deficit > 0:
                for _ in range(deficit):
                    self._dispatch_prewarm(model, t)
                continue
            idle_for = math.inf if last_arrival is None \
                else t - last_arrival
            if st.live > max(target, self.min_warm) and \
                    idle_for >= self.idle_scale_in_s:
                n = pool.scale_in(max(target, self.min_warm), now=t)
                if n:
                    self.metrics.counter(
                        f"autoscaler/{model}/scale_ins").inc(n)
        return targets

    def _dispatch_prewarm(self, model: str, now: float):
        with self._cv:
            self._inflight[model] = self._inflight.get(model, 0) + 1
        self._pool.submit(self._prewarm_job, model, now)

    def _prewarm_job(self, model: str, now: float):
        pool = self.pools[model]
        try:
            with _on_device(getattr(pool, "device", None)):
                ok = pool.prewarm(logical_now=now)
            if ok:
                self.metrics.counter(f"autoscaler/{model}/prewarms").inc()
        except Exception:
            # a failed prewarm is capacity we didn't get, not a request
            # failure: count it and let the next tick retry
            self.metrics.counter(f"autoscaler/{model}/prewarm_errors").inc()
        finally:
            with self._cv:
                self._inflight[model] -= 1
                self._cv.notify_all()

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Run :meth:`tick` every ``interval_s`` on a daemon thread."""
        with self._cv:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(target=self._run,
                                            name="autoscaler",
                                            daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                deadline = time.monotonic() + self.interval_s
                while not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                if self._stop:
                    return
            self.tick()

    def stop(self, *, wait_inflight: bool = True):
        """Stop the background thread; optionally wait for in-flight
        prewarm jobs so a shutting-down bench observes stable state."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()
        if wait_inflight:
            with self._cv:
                while any(self._inflight.values()):
                    self._cv.wait()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def _on_device(device) -> contextlib.AbstractContextManager:
    """Make a CUDA pool's device current on this worker thread (a new
    thread starts on device 0); nothing for the CPU or a stand-in pool."""
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
