"""Serverless serving engine: trace replay on the Router/InstancePool
platform API, plus the LM-server shim (a port of
``repro.serving.engine``).

:class:`ServerlessPlatform` wires one :class:`InstancePool` per deployed
model behind a :class:`Router` and replays invocation traces through it.
``run_trace(..., concurrency=N)`` admits up to N invocations
concurrently (N router workers); ``concurrency=1`` replays strictly
serially.  ``run_trace(..., make_spec=...)`` replays the trace as
*generation* requests — each invocation decodes through the instances'
continuous-batching DecodeSchedulers and its Response carries tokens /
TTFT / TPOT.  Keep-alive accounting runs on the trace's *logical* clock
regardless of replay speed: before each submission the platform sweeps
every pool, and the eviction policy (default: a TTL) reclaims idle
instances — re-triggering cold starts, the serverless lifecycle of the
paper's Fig. 2.

``autoscale=`` attaches the SLO :class:`~repro_torch.serving.autoscale.
Autoscaler` to the platform's pools and routers.  ``source=`` wires a
cluster node's peer-exchange tier into every pool's cold starts (see
:mod:`repro_torch.cluster`).  Single device: the reference's mesh options
(``mesh_shape``, ``rules``) are ROADMAP queue 1 item 13; passing them
raises.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import metrics as metrics_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.api import GenerateSpec, Request, Response
from repro_torch.serving.autoscale import Autoscaler
from repro_torch.serving.decode import DecodeScheduler
from repro_torch.serving.policy import EvictionPolicy, make_policy
from repro_torch.serving.pool import InstancePool
from repro_torch.serving.router import Router
from repro_torch.store.cache import CacheStats, WeightCache
from repro_torch.store.store import WeightStore

PyTree = Any


class ServerlessPlatform:
    """Trace-driven multi-function platform (one pool per model)."""

    def __init__(self, store: WeightStore,
                 builders: Dict[str, Callable[[], tuple]], *,
                 strategy: str = "cicada", keep_alive_s: float = 60.0,
                 io_workers: int = 4, chunk_bytes: int = 1 << 20,
                 max_instances: int = 1,
                 policy: Optional[EvictionPolicy] = None,
                 cache_budget_bytes: Optional[int] = None,
                 cache: Optional[WeightCache] = None,
                 gen_slots: int = 8, gen_cache_len: int = 256,
                 kv_page_tokens: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 mesh_shape=None, rules=None, compute_quant: bool = False,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 autoscale: Optional[Dict[str, Any]] = None,
                 source=None, device: DeviceLike = None):
        """builders: model_name -> () -> (model, example_batch).

        cache_budget_bytes: enable ONE node-local WeightCache shared by
        every pool — scale-out and re-triggered cold starts then reuse
        already-retrieved unit leaves and single-flight store reads
        (None -> no cache; 0 -> unbounded).  Pass ``cache`` to share an
        externally-owned cache instead.

        gen_slots / gen_cache_len: per-instance continuous-batching
        capacity — up to gen_slots concurrent generation requests share
        one slotted KV cache of gen_cache_len positions per slot.

        kv_page_tokens / kv_budget_bytes: block-paged decode KV — every
        instance's scheduler serves full-attention KV from a shared
        refcounted page pool (kv_page_tokens positions per page, pool
        sized by kv_budget_bytes; None -> slotted-arena-equivalent page
        count), with prefix reuse.

        compute_quant: serve int8-deployed models quantized-resident —
        cold starts keep the int8 values + scales as QuantLeaf params
        and forwards run through the ``quant_matmul`` kernel.

        metrics: registry behind :meth:`metrics_snapshot`; defaults to a
        *private* registry so each platform's snapshot is isolated.

        autoscale: when not None, build an
        :class:`~repro_torch.serving.autoscale.Autoscaler` over this
        platform's pools with these kwargs (e.g.
        ``dict(rps_per_instance=2.0, min_warm=1)``; ``{}`` for
        defaults).  The autoscaler is attached to every Router this
        platform creates; drive it with ``platform.autoscaler.start()``
        (background ticks) or explicit ``tick()`` calls.

        device: where every instance loads and serves (default: the GPU;
        raises without one unless ``device="cpu"``).

        source: ShardSource wired into every pool's cold-start retrieval
        streams — a cluster Node passes its peer-exchange tier here (see
        :mod:`repro_torch.cluster`); requires a cache.

        mesh_shape / rules: not ported yet (ROADMAP queue 1 item 13);
        anything but None raises.
        """
        if mesh_shape is not None or rules is not None:
            raise NotImplementedError(
                "shard-granular serving (mesh_shape=, rules=) is not ported "
                "yet — ROADMAP queue 1 item 13")
        self.store = store
        self.strategy = strategy
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None \
            else metrics_mod.MetricsRegistry()
        self.policy = policy if policy is not None \
            else make_policy(keep_alive_s)
        if cache is None and cache_budget_bytes is not None:
            cache = WeightCache(cache_budget_bytes, metrics=self.metrics)
        self.cache = cache
        self.source = source
        self.pools: Dict[str, InstancePool] = {
            name: InstancePool(name, builder, store, strategy=strategy,
                               policy=self.policy,
                               max_instances=max_instances,
                               io_workers=io_workers,
                               chunk_bytes=chunk_bytes,
                               cache=self.cache,
                               gen_slots=gen_slots,
                               gen_cache_len=gen_cache_len,
                               kv_page_tokens=kv_page_tokens,
                               kv_budget_bytes=kv_budget_bytes,
                               compute_quant=compute_quant,
                               metrics=self.metrics, source=source,
                               device=self.device)
            for name, builder in builders.items()}
        self.autoscaler: Optional[Autoscaler] = None
        if autoscale is not None:
            self.autoscaler = Autoscaler(self.pools, metrics=self.metrics,
                                         **autoscale)
        self.last_router_stats = None      # RouterStats of the last replay

    def router(self, *, workers: int = 4,
               max_pending: Optional[int] = None) -> Router:
        """A live Router over this platform's pools (caller shuts down)."""
        return Router(self.pools, workers=workers, max_pending=max_pending,
                      cache=self.cache, metrics=self.metrics,
                      autoscaler=self.autoscaler)

    def cache_stats(self) -> Optional[CacheStats]:
        """Counters of the shared node-local WeightCache (None when
        serving cache-less)."""
        return self.cache.stats() if self.cache is not None else None

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The scrapeable observability surface: every live instrument
        (counters / gauges / histograms) plus point-in-time instance
        states refreshed from the pools at snapshot time."""
        for name, pool in self.pools.items():
            st = pool.stats()
            g = self.metrics.gauge
            g(f"pool/{name}/instances").set(st.size)
            g(f"pool/{name}/live").set(st.live)
            g(f"pool/{name}/busy").set(st.busy)
            g(f"pool/{name}/gen_active").set(st.gen_active)
        if self.cache is not None:
            cs = self.cache.stats()
            self.metrics.gauge("weight_cache/bytes").set(cs.bytes_cached)
            self.metrics.gauge("weight_cache/entries").set(cs.entries)
        return self.metrics.snapshot()

    def sweep(self, logical_now: float) -> int:
        """Run keep-alive eviction across all pools (idle instances
        only); returns the number of instances reclaimed."""
        return sum(p.sweep(logical_now) for p in self.pools.values())

    def pool_stats(self) -> Dict[str, Any]:
        return {name: p.stats() for name, p in self.pools.items()}

    def run_trace(self, invocations, make_batch,
                  *, time_scale: float = 0.0,
                  concurrency: int = 1,
                  make_spec: Optional[Callable[[str], GenerateSpec]] = None
                  ) -> List[Response]:
        """Replay a trace.  time_scale=0 -> as-fast-as-possible (arrival
        gaps are skipped but keep-alive accounting still uses the
        *logical* clock); >0 -> sleep scaled real time between arrivals.

        concurrency=1 replays strictly serially (``latency_s`` measures
        the invocation only — instance provisioning and queue wait are
        reported in ``queue_s``); concurrency=N>1 keeps up to N
        invocations in flight through the Router's worker pool.
        Keep-alive stays logical-clock faithful per request: expired
        idle instances are evicted at acquire time against the
        *requester's* arrival time, though an instance kept busy by
        overlapping requests counts as continuously active (so cold/warm
        mixes can differ from serial replay under contention).

        make_spec: model_name -> GenerateSpec.  When given, the trace
        replays as *generation* requests (make_batch is unused) —
        concurrent invocations of one model join its instance's decode
        scheduler and batch dynamically; each Response carries tokens,
        ttft_s and tpot_s.

        A request that fails raises here, from its future's result.
        """
        router = self.router(workers=max(1, concurrency))
        try:
            futures = []
            logical_prev = None
            clock = 0.0
            for inv in invocations:
                if logical_prev is not None:
                    gap = inv.t - logical_prev
                    clock += gap
                    if time_scale > 0:
                        time.sleep(gap * time_scale)
                logical_prev = inv.t
                # logical keep-alive: evict instances idle past the TTL
                self.sweep(clock)
                if make_spec is not None:
                    req = Request(req_id=inv.req_id, model=inv.model,
                                  gen=make_spec(inv.model), t_logical=clock)
                else:
                    req = Request(req_id=inv.req_id, model=inv.model,
                                  batch=make_batch(inv.model),
                                  t_logical=clock)
                fut = router.submit(req)
                futures.append(fut)
                if concurrency <= 1:
                    fut.result()           # strict serial replay
            return [f.result() for f in futures]
        finally:
            router.shutdown()
            self.last_router_stats = router.stats


# ---------------------------------------------------------------------------
# LM batched serving — shim over the DecodeScheduler
# ---------------------------------------------------------------------------

class BatchedLMServer:
    """The static-batch server surface, served by the slot-based
    continuous-batching :class:`DecodeScheduler`.

    ``max_batch`` is the scheduler's slot count, and a prompt+n_new that
    overflows ``cache_len`` raises
    :class:`~repro_torch.serving.api.CacheOverflowError`."""

    def __init__(self, model, params: PyTree, *, max_batch: int = 8,
                 cache_len: int = 256):
        self.model = model
        self.params = params
        self.max_batch = int(max_batch)
        self.cache_len = int(cache_len)
        self.scheduler = DecodeScheduler(model, params, n_slots=max_batch,
                                         cache_len=cache_len)

    def generate(self, tokens: torch.Tensor, *, n_new: int,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0) -> torch.Tensor:
        """tokens: (B, S) prompt batch -> (B, n_new) generated ids.

        Rows are submitted as B concurrent generation requests, so they
        decode as one continuous batch through the shared slotted KV
        cache."""
        B, S = tokens.shape
        if B > self.max_batch:
            raise ValueError(
                f"batch {B} exceeds max_batch={self.max_batch} "
                f"(the scheduler's slot count)")
        specs = [GenerateSpec(prompt=tokens[b], n_new=n_new,
                              temperature=0.0 if greedy else temperature,
                              seed=seed + b)
                 for b in range(B)]
        if B == 1:
            rows = [self.scheduler.generate(specs[0]).tokens]
        else:
            with ThreadPoolExecutor(max_workers=B) as ex:
                rows = list(ex.map(
                    lambda s: self.scheduler.generate(s).tokens, specs))
        return torch.tensor(rows, dtype=torch.int32)
