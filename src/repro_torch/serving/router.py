"""Thread-safe request router: concurrent admission, priority dispatch
(a port of ``repro.serving.router``).

The Router is the platform's front door.  Any number of threads may
:meth:`submit` concurrently; each submission is

  1. **admitted** — rejected with :class:`AdmissionError` when the
     pending queue is at capacity (admission control keeps a saturated
     platform's queueing delay bounded instead of unbounded);
  2. **classified** — explicit ``Request.cls`` wins, otherwise
     warm-servable requests become INFERENCE and cold starts COLDSTART:
     the Priority-Aware Scheduler's "inference first" rule applied at
     the routing layer;
  3. **queued by class** — a worker pool drains the queue
     highest-priority-first (FIFO within a class) and drives the
     request through the model's :class:`InstancePool`.

``submit`` returns a ``concurrent.futures.Future[Response]``.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import analysis, metrics as metrics_mod
from repro_torch.serving.api import (AdmissionError, Request, RequestClass,
                                     Response, RouterStats,
                                     UnknownModelError)
from repro_torch.serving.pool import InstancePool


def _resolve(fut: "Future", *, result=None, exc=None):
    """Terminal Future transition that tolerates a concurrent cancel —
    set_result/set_exception on a cancelled future raises
    InvalidStateError, which would otherwise kill the worker thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class Router:
    def __init__(self, pools: Dict[str, InstancePool], *, workers: int = 4,
                 max_pending: Optional[int] = None,
                 acquire_timeout_s: float = 0.1,
                 cache: Optional[Any] = None,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 autoscaler: Optional[Any] = None):
        """``acquire_timeout_s``: how long a worker may block on a
        saturated pool before requeueing the request (to the tail of
        its class) and serving other queued work — keeps a slow cold
        pool from absorbing the whole worker pool and starving
        higher-priority inference requests.

        ``cache``: the node-local WeightCache behind this router's
        pools, exposed for observability (``cache_stats``); the pools
        themselves consult it during cold starts.

        ``metrics``: registry for the live instruments
        (``router/submitted``, ``router/queue_depth``,
        ``router/latency_s/<class>``, ``router/ttft_s``, ...);
        falls back to the process default.

        ``autoscaler``: optional
        :class:`~repro_torch.serving.autoscale.Autoscaler` — every
        admitted request is reported to it (arrival-rate signal), and it
        reads :meth:`queue_depth` back when sizing pools."""
        self.pools = pools
        self.max_pending = max_pending
        self.acquire_timeout_s = acquire_timeout_s
        self.cache = cache
        self.metrics = metrics_mod.resolve(metrics)
        self.autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.router = self
        self.stats = RouterStats()
        self._cv = analysis.make_condition("Router._cv")
        # (class, seq, Request, Future)
        self._heap: list = []              # guarded-by: _cv
        self._seq = itertools.count()
        self._stop = False                 # guarded-by: _cv
        self._in_flight = 0                # guarded-by: _cv
        self._workers = [threading.Thread(target=self._worker,
                                          name=f"router-worker-{i}",
                                          daemon=True)
                         for i in range(max(1, workers))]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------ admission
    def _classify(self, req: Request) -> RequestClass:
        pool = self.pools.get(req.model)
        if pool is not None and pool.any_live():
            return RequestClass.INFERENCE
        return RequestClass.COLDSTART

    def submit(self, req: Request) -> "Future[Response]":
        """Admit one invocation; returns a Future resolving to its
        Response (or raising the dispatch error).  Unknown models fail
        here, on the submitting thread, with a typed error — not with a
        bare KeyError surfacing from a worker."""
        if req.model not in self.pools:
            raise UnknownModelError(
                f"no pool for model {req.model!r}; deployed: "
                f"{sorted(self.pools)}")
        req.t_submit = time.monotonic()
        if req.cls is None:
            req.cls = self._classify(req)
        fut: "Future[Response]" = Future()
        with self._cv:
            if self._stop:
                raise RuntimeError("router is shut down")
            if self.max_pending is not None and \
                    len(self._heap) >= self.max_pending:
                self.stats.rejected += 1
                self.metrics.counter("router/rejected").inc()
                raise AdmissionError(
                    f"queue at capacity ({self.max_pending} pending)")
            self.stats.submitted += 1
            heapq.heappush(self._heap,
                           (int(req.cls), next(self._seq), req, fut))
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             len(self._heap))
            depth = len(self._heap)
            self._cv.notify()
        self.metrics.counter("router/submitted").inc()
        self.metrics.gauge("router/queue_depth").set(depth)
        if self.autoscaler is not None:
            self.autoscaler.observe(req.model)
        return fut

    def queue_depth(self) -> int:
        """Pending (not yet dispatched) requests across all classes —
        the backlog signal the autoscaler reads."""
        with self._cv:
            return len(self._heap)

    # ------------------------------------------------------------- dispatch
    def _worker(self):
        while True:
            with self._cv:
                while not self._heap and not self._stop:
                    self._cv.wait()
                if not self._heap:
                    return                 # stopped and drained
                _, _, req, fut = heapq.heappop(self._heap)
                depth = len(self._heap)
            self.metrics.gauge("router/queue_depth").set(depth)
            self._dispatch(req, fut)

    def _requeue(self, req: Request, fut: "Future[Response]"):
        """Pool saturated: requeue at the tail of the request's class so
        this worker can serve other (higher-priority) work."""
        with self._cv:
            heapq.heappush(self._heap,
                           (int(req.cls), next(self._seq), req, fut))
            self._cv.notify()

    def _dispatch(self, req: Request, fut: "Future[Response]"):
        if req.gen is not None:
            return self._dispatch_gen(req, fut)
        pool = self.pools[req.model]
        self._serve(req, fut, pool,
                    acquire=lambda: pool.acquire(
                        timeout=self.acquire_timeout_s,
                        logical_now=req.t_logical),
                    release=pool.release,
                    service=lambda inst: inst.invoke(req.batch))

    def _dispatch_gen(self, req: Request, fut: "Future[Response]"):
        """Generation dispatch: a *shared* pool hold — concurrent
        requests join one instance's continuous-batching decode
        scheduler instead of serializing behind exclusive acquire.  A
        cold instance is held exclusively only for the pipeline load
        (its first token is produced in-pipeline); mark_live then opens
        it to joiners mid-request."""
        pool = self.pools[req.model]

        def service(inst, joinable):
            on_live = None if joinable else \
                (lambda i=inst: pool.mark_live(i))
            return inst.generate(req.gen, on_live=on_live)

        def extra(result, t_arr):
            return dict(tokens=np.asarray(result.tokens, np.int32),
                        ttft_s=result.t_first - t_arr,
                        tpot_s=result.tpot_s)

        self._serve(req, fut, pool,
                    acquire=lambda: pool.acquire_gen(
                        timeout=self.acquire_timeout_s,
                        logical_now=req.t_logical),
                    release=pool.release_gen,
                    service=service, extra=extra)

    def _serve(self, req: Request, fut: "Future[Response]", pool, *,
               acquire, release, service, extra=None):
        """The dispatch skeleton shared by the one-shot and generation
        paths: acquire with requeue-on-timeout, claim the future, track
        in-flight, serve, release, resolve.  ``acquire`` may return an
        instance or an ``(instance, ...)`` tuple whose tail is passed
        through to ``service``; ``extra(result, t_arr)`` contributes
        path-specific Response fields."""
        inst = None
        try:
            try:
                got = acquire()
            except TimeoutError:
                self._requeue(req, fut)
                return
            inst, *rest = got if isinstance(got, tuple) else (got,)
            # claim the future before doing work: a request cancelled
            # while queued is dropped here instead of being served into
            # a dead future (whose set_result would kill this worker)
            if not fut.set_running_or_notify_cancel():
                release(inst, logical_now=req.t_logical)
                return
            # service starts here: t_arrival/latency_s measure the
            # invocation itself — router queueing,
            # pool waits and instance provisioning live in queue_s
            t_arr = time.monotonic()
            with self._cv:
                self._in_flight += 1
                self.stats.max_in_flight = max(self.stats.max_in_flight,
                                               self._in_flight)
            self.metrics.gauge("router/in_flight").add(1)
            try:
                result, info = service(inst, *rest)
            finally:
                with self._cv:
                    self._in_flight -= 1
                self.metrics.gauge("router/in_flight").add(-1)
            t_done = time.monotonic()
            release(inst, logical_now=req.t_logical, cold=info["cold"])
            inst = None
            with self._cv:
                self.stats.completed += 1
            resp = Response(
                req_id=req.req_id, model=req.model, cold=info["cold"],
                t_arrival=t_arr, t_done=t_done,
                load_s=info["load_s"], infer_s=info["infer_s"],
                utilization=info["utilization"],
                queue_s=t_arr - req.t_submit, cls=req.cls,
                **(extra(result, t_arr) if extra is not None else {}))
            self._record(resp)
            _resolve(fut, result=resp)
        except BaseException as e:
            if inst is not None:
                release(inst, logical_now=req.t_logical)
            self.metrics.counter("router/errors").inc()
            _resolve(fut, exc=e)

    def _record(self, resp: Response):
        """Per-completion instruments.  latency_s is keyed by request
        class (the Priority-Aware Scheduler's unit of SLO accounting);
        ttft_s here is end-to-end *from submit* — queue wait plus the
        service-side first-token time — because that is what a client's
        SLO sees, unlike ``Response.ttft_s`` which starts at service."""
        m = self.metrics
        m.counter("router/completed").inc()
        m.counter("router/cold" if resp.cold else "router/warm").inc()
        m.histogram("router/queue_s").observe(resp.queue_s)
        cls = resp.cls.name.lower() if resp.cls is not None else "unknown"
        m.histogram(f"router/latency_s/{cls}").observe(resp.latency_s)
        if resp.ttft_s is not None:
            m.histogram("router/ttft_s").observe(resp.queue_s + resp.ttft_s)
        if resp.tpot_s:
            h = m.histogram("router/tpot_s")
            for dt in resp.tpot_s:
                h.observe(dt)

    def cache_stats(self):
        """CacheStats of the attached node-local WeightCache (None when
        serving cache-less)."""
        return self.cache.stats() if self.cache is not None else None

    # ------------------------------------------------------------- shutdown
    def shutdown(self, wait: bool = True):
        """Stop accepting work; workers drain the queue, then exit."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if wait:
            for t in self._workers:
                t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
