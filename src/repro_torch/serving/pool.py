"""Function instances and per-model instance pools (a port of
``repro.serving.pool``).

One :class:`FunctionInstance` models a container: it holds (at most) one
live model.  The first request after provisioning is a **cold start**
and goes through the Cicada pipeline (``ColdStartEngine``) — the
triggering request's inference is computed layer-by-layer *inside* the
loading pipeline.  Subsequent requests are **warm**: direct steady-state
forward, or — for generation requests — a join into the instance's
:class:`~repro_torch.serving.decode.DecodeScheduler`, the slot-based
continuous-batching decode engine each live instance owns.

:class:`InstancePool` owns up to ``max_instances`` containers for one
model function and hands them out under two disciplines:

  * **exclusive** (:meth:`InstancePool.acquire`): one-shot forwards and
    cold-start pipeline loads — a cold model hit by concurrent requests
    either rides the one in-flight pipeline (followers wait and are
    served warm) or scales out onto a fresh instance, never two
    pipelines loading into the same container;
  * **shared generation** (:meth:`InstancePool.acquire_gen`): any number
    of generation requests up to the scheduler's slot count may hold a
    *live* instance concurrently — that co-residency is what lets them
    batch dynamically.  A cold instance is first held exclusively for
    the pipeline load; :meth:`InstancePool.mark_live` then opens it to
    joiners mid-request.
  * keep-alive is delegated to an :class:`~repro_torch.serving.policy.
    EvictionPolicy`; :meth:`InstancePool.sweep` offers only *idle*
    instances to it on whatever clock the caller advances (logical
    trace time in replay); instances with resident generations are
    busy, hence never offered;
  * :meth:`InstancePool.stats` exposes cold/warm/eviction/generation
    counters.

On the GPU an evicted instance drops every tensor it held on the card
(params, the scheduler's KV cache, the last load's logits), so the
caching allocator can hand that memory to the next load.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import analysis, metrics as metrics_mod
from repro_torch.core.coldstart import ColdStartEngine, LoadResult
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.serving.api import GenerateSpec, PoolStats
from repro_torch.serving.decode import (DecodeScheduler, GenResult,
                                        _as_prompt, paged_page_count,
                                        sample_first, validate_spec,
                                        validate_spec_paged)
from repro_torch.serving.policy import EvictionPolicy, NeverEvict
from repro_torch.store.cache import WeightCache
from repro_torch.store.store import WeightStore

PyTree = Any


def _unported(mesh_shape, rules):
    """The reference's mesh options, not ported yet."""
    if mesh_shape is not None or rules is not None:
        raise NotImplementedError(
            "shard-granular cold starts (mesh_shape=, rules=) are not "
            "ported yet — ROADMAP queue 1 item 13")


class FunctionInstance:
    """A container with one deployed model function.

    Not internally synchronized: the owning pool guarantees at most one
    request holds an instance between acquire() and release()."""

    def __init__(self, model, model_name: str, store: WeightStore, *,
                 strategy: str = "cicada", io_workers: int = 4,
                 chunk_bytes: int = 1 << 20, warm: bool = True,
                 example_batch: Optional[Dict[str, Any]] = None,
                 cache: Optional[WeightCache] = None,
                 gen_slots: int = 8, gen_cache_len: int = 256,
                 kv_page_tokens: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 mesh_shape=None, rules=None, compute_quant: bool = False,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 source=None, device: DeviceLike = None):
        """gen_slots / gen_cache_len: capacity of this container's
        continuous-batching DecodeScheduler — concurrent generation
        requests up to gen_slots share one slotted KV cache of
        gen_cache_len positions per slot.

        compute_quant: int8-deployed models stay quantized-resident
        (QuantLeaf params + ``quant_matmul``) instead of being
        dequantized at application — see ColdStartEngine.

        warm: with an ``example_batch``, run ``engine.warmup`` at
        provisioning — on the GPU that builds the kernel library and
        warms the path — so no request pays for it (and racing first
        requests of several models do not build it together).

        device: where the instance loads and serves (default: the GPU;
        raises without one unless ``device="cpu"``).

        source: ShardSource for the cold starts' cache-missing
        retrieval streams (a cluster node's peer-exchange tier; default:
        the origin store).

        mesh_shape / rules: not ported yet; anything but None raises."""
        _unported(mesh_shape, rules)
        self.model = model
        self.model_name = model_name
        self.example_batch = example_batch
        self.engine = ColdStartEngine(model, model_name, store,
                                      strategy=strategy,
                                      io_workers=io_workers,
                                      chunk_bytes=chunk_bytes,
                                      compute_quant=compute_quant,
                                      cache=cache, metrics=metrics,
                                      source=source, device=device)
        self.device = self.engine.device
        self.metrics = metrics_mod.resolve(metrics)
        self.params: Optional[PyTree] = None
        self.last_load: Optional[LoadResult] = None
        self.gen_slots = int(gen_slots)
        self.gen_cache_len = int(gen_cache_len)
        # kv_page_tokens != None switches the scheduler to block-paged
        # KV (kv_budget_bytes caps the pool; None -> slotted-equivalent)
        self.kv_page_tokens = kv_page_tokens
        self.kv_budget_bytes = kv_budget_bytes
        self.scheduler: Optional[DecodeScheduler] = None
        # guards scheduler creation: warm generation joiners are NOT
        # serialized by the pool (shared holds), so two may race here
        self._sched_lock = analysis.make_lock(
            "FunctionInstance._sched_lock")
        if warm and example_batch is not None:
            self.engine.warmup(example_batch)

    @property
    def live(self) -> bool:
        return self.params is not None

    def _loaded(self, res: LoadResult):
        self.params = res.params
        self.last_load = res

    def ensure_live(self) -> bool:
        """Run the cold-start pipeline proactively (prewarm): load params
        using the warmup example batch, *off* any request.  Returns True
        when a load ran, False when already live."""
        if self.live:
            return False
        if self.example_batch is None:
            raise RuntimeError(
                f"instance for {self.model_name!r} has no example_batch; "
                "cannot prewarm without a representative input")
        self._loaded(self.engine.load(self.example_batch))
        return True

    def evict(self):
        """Drop the params and the scheduler (with its KV cache), and the
        last load's tensors, so their device memory is freed; the load's
        trace stays readable."""
        self.params = None
        self.scheduler = None          # the KV cache dies with the params
        if self.last_load is not None:
            self.last_load = dataclasses.replace(self.last_load,
                                                 logits=None, params=None)

    def invoke(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, dict]:
        """Returns (logits, {"cold": bool, "load_s": float, "infer_s"})."""
        if not self.live:
            res = self.engine.load(batch)
            self._loaded(res)
            return res.logits, {"cold": True,
                                "load_s": res.trace.total_time(),
                                "infer_s": 0.0,
                                "utilization": res.trace.utilization()}
        t0 = time.monotonic()
        dev = self.device
        logits, _ = self.model.forward(
            self.params, {k: torch.as_tensor(v).to(dev)
                          for k, v in batch.items()})
        synchronize(dev)
        return logits, {"cold": False, "load_s": 0.0,
                        "infer_s": time.monotonic() - t0,
                        "utilization": 1.0}

    # ------------------------------------------------------------ generation
    def _ensure_scheduler(self) -> DecodeScheduler:
        if self.scheduler is None:
            with self._sched_lock:
                if self.scheduler is None:
                    self.scheduler = DecodeScheduler(
                        self.model, self.params, n_slots=self.gen_slots,
                        cache_len=self.gen_cache_len,
                        kv_page_tokens=self.kv_page_tokens,
                        kv_budget_bytes=self.kv_budget_bytes,
                        metrics=self.metrics)
        return self.scheduler

    def generate(self, spec: GenerateSpec, *,
                 on_live: Optional[Callable[[], None]] = None
                 ) -> Tuple[GenResult, dict]:
        """Serve one generation request on this container.

        Cold: the Cicada pipeline loads the model AND answers the
        prompt — the first token is sampled from the pipeline's
        in-flight logits the moment the final E completes (TTFT lands
        within the load), then the request migrates into the decode
        scheduler at position S+1.  Warm: prefill + join directly.

        on_live: called once the instance holds params and a scheduler
        (immediately when already warm) — the pool uses it to open a
        cold-held instance to concurrent joiners mid-request.
        """
        prompt = _as_prompt(spec.prompt, self.device)
        n_prompt = int(prompt.shape[1])
        # fail before the expensive load, not after
        if self.kv_page_tokens:
            n_pages = paged_page_count(
                self.model, page_tokens=self.kv_page_tokens,
                budget_bytes=self.kv_budget_bytes,
                n_slots=self.gen_slots, cache_len=self.gen_cache_len)
            # per-request ceiling mirrors DecodeScheduler's np_max
            # default (page-table width = ceil(cache_len / pt))
            np_max = max(1, min(
                n_pages, -(-self.gen_cache_len // self.kv_page_tokens)))
            sched = self.scheduler
            validate_spec_paged(
                spec, n_prompt, page_tokens=self.kv_page_tokens,
                n_pages=np_max,
                stats=sched.kvpool.stats() if sched is not None else None)
        else:
            validate_spec(spec, n_prompt, self.gen_cache_len)
        if not self.live:
            first: Dict[str, Any] = {}

            def _first_token(logits):
                # called on the compute unit's thread with its CUDA stream
                # current, after that stream's work was waited for: the
                # sampling below is ordered after the logits' producer
                first["token"] = sample_first(logits, spec, n_prompt)
                first["t"] = time.monotonic()

            res = self.engine.load({"tokens": prompt},
                                   on_logits=_first_token)
            self._loaded(res)
            self._ensure_scheduler()
            if on_live is not None:
                on_live()
            result = self.scheduler.generate(spec,
                                             first_token=first["token"],
                                             t_first=first["t"])
            return result, {"cold": True,
                            "load_s": res.trace.total_time(),
                            "infer_s": 0.0,
                            "utilization": res.trace.utilization()}
        self._ensure_scheduler()
        if on_live is not None:
            on_live()
        t0 = time.monotonic()
        result = self.scheduler.generate(spec)
        return result, {"cold": False, "load_s": 0.0,
                        "infer_s": time.monotonic() - t0,
                        "utilization": 1.0}


class InstancePool:
    """Thread-safe pool of FunctionInstances for one model function."""

    # After an exclusive acquire() times out, new generation joins stay
    # paused this long (refreshed on every timeout, cleared the moment
    # an exclusive acquire succeeds).  Covers the Router's
    # requeue-and-retry gap, during which no acquire() is parked in
    # wait(); bounded so an abandoned requester can't block generation
    # service forever.
    EXCL_STARVATION_GRACE_S = 5.0

    def __init__(self, model_name: str,
                 builder: Optional[Callable[[], Tuple[Any, Dict]]],
                 store: Optional[WeightStore] = None, *,
                 strategy: str = "cicada",
                 policy: Optional[EvictionPolicy] = None,
                 max_instances: int = 1, io_workers: int = 4,
                 chunk_bytes: int = 1 << 20,
                 instance_factory: Optional[Callable[[], Any]] = None,
                 cache: Optional[WeightCache] = None,
                 gen_slots: int = 8, gen_cache_len: int = 256,
                 kv_page_tokens: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 mesh_shape=None, rules=None, compute_quant: bool = False,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 source=None, device: DeviceLike = None):
        """builder: () -> (model, example_batch).  ``instance_factory``
        overrides container provisioning (tests); the default builds a
        warmed FunctionInstance.  ``cache``: one node-local WeightCache
        shared by every instance of this pool (and, via the platform,
        across pools) — concurrent scale-out cold starts then
        single-flight each unit's store read.
        ``gen_slots``/``gen_cache_len``: per-instance DecodeScheduler
        capacity (concurrent generation residency / KV positions).
        ``source``: ShardSource for cache-missing retrieval streams
        (the cluster peer-exchange tier; default: the origin store).
        ``device``: where the default instances load and serve.
        ``mesh_shape``/``rules``: not ported yet (raise)."""
        _unported(mesh_shape, rules)
        self.model_name = model_name
        self.policy = policy if policy is not None else NeverEvict()
        self.max_instances = max(1, int(max_instances))
        self.cache = cache
        self.source = source
        self.gen_slots = int(gen_slots)
        self.gen_cache_len = int(gen_cache_len)
        self.kv_page_tokens = kv_page_tokens
        self.kv_budget_bytes = kv_budget_bytes
        self.compute_quant = compute_quant
        # resolved now, so a pool of real instances raises without a GPU
        # before any request; stand-in factories bring their own
        self.device = resolve_device(device) if instance_factory is None \
            else device
        self._builder = builder
        self._store = store
        self._strategy = strategy
        self._io_workers = io_workers
        self._chunk_bytes = chunk_bytes
        self._factory = instance_factory or self._default_factory
        self._cv = analysis.make_condition("InstancePool._cv")
        self._instances: List[Any] = []            # guarded-by: _cv
        self._idle: List[Any] = []                 # guarded-by: _cv
        self._busy: List[Any] = []                 # guarded-by: _cv
        self._creating = 0                         # guarded-by: _cv
        # id(inst) -> logical t
        self._last_used: Dict[int, float] = {}     # guarded-by: _cv
        # id(inst) -> joined gens
        self._gen_count: Dict[int, int] = {}       # guarded-by: _cv
        self._gen_cold: set = set()                # guarded-by: _cv
        # acquire() calls in wait
        self._excl_waiters = 0                     # guarded-by: _cv
        # sticky join pause
        self._excl_starved_until = 0.0             # guarded-by: _cv
        self._cold_starts = 0                      # guarded-by: _cv
        self._warm_hits = 0                        # guarded-by: _cv
        self._evictions = 0                        # guarded-by: _cv
        self._prewarms = 0                         # guarded-by: _cv
        self.metrics = metrics_mod.resolve(metrics)
        # metric instruments are leaf locks: incrementing under _cv
        # adds only a _cv -> instrument edge, never a cycle
        self._m_cold = self.metrics.counter(f"pool/{model_name}/cold_starts")
        self._m_warm = self.metrics.counter(f"pool/{model_name}/warm_hits")
        self._m_evict = self.metrics.counter(f"pool/{model_name}/evictions")
        self._m_prewarm = self.metrics.counter(f"pool/{model_name}/prewarms")
        # generation holds, set on every change: its high-water mark is
        # the most requests that were joined at once
        self._m_gen = self.metrics.gauge(f"pool/{model_name}/gen_active")

    def _default_factory(self):
        model, example = self._builder()
        return FunctionInstance(model, self.model_name, self._store,
                                strategy=self._strategy,
                                io_workers=self._io_workers,
                                chunk_bytes=self._chunk_bytes,
                                example_batch=example,
                                cache=self.cache,
                                gen_slots=self.gen_slots,
                                gen_cache_len=self.gen_cache_len,
                                kv_page_tokens=self.kv_page_tokens,
                                kv_budget_bytes=self.kv_budget_bytes,
                                compute_quant=self.compute_quant,
                                metrics=self.metrics,
                                source=self.source,
                                device=self.device)

    # ------------------------------------------------------------ lifecycle
    def acquire(self, *, timeout: Optional[float] = None,
                logical_now: Optional[float] = None):
        """Reserve an instance exclusively.  Preference order: a warm
        (live) idle instance, then a cold idle one, then scale-out up to
        ``max_instances``; otherwise block until a release.

        ``logical_now``: the requester's logical arrival time — idle
        instances whose keep-alive expired *before* this request are
        evicted here rather than reused warm, so eviction semantics
        stay per-request faithful even when replay runs far ahead of
        the logical clock (concurrent as-fast-as-possible replay)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if logical_now is not None:
                    self._evict_expired_locked(logical_now)
                inst = next((i for i in self._idle if i.live), None)
                if inst is None and self._idle:
                    inst = self._idle[0]
                if inst is not None:
                    self._idle.remove(inst)
                    self._busy.append(inst)
                    self._excl_starved_until = 0.0   # exclusive won
                    return inst
                if len(self._instances) + self._creating \
                        < self.max_instances:
                    self._creating += 1
                    self._excl_starved_until = 0.0   # exclusive won
                    break
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    # the requester will likely requeue and retry (the
                    # Router's loop): keep joins paused across the gap,
                    # or a continuous joiner stream wins every race
                    self._excl_starved_until = time.monotonic() + \
                        self.EXCL_STARVATION_GRACE_S
                    raise TimeoutError(
                        f"pool {self.model_name!r} saturated "
                        f"({self.max_instances} instances busy)")
                # while we wait, _gen_candidate_locked grants no new
                # joins, so shared generation holds drain instead of
                # starving us
                self._excl_waiters += 1
                try:
                    self._cv.wait(remaining)
                finally:
                    self._excl_waiters -= 1
        return self._provision()

    # --------------------------------------------------- shared generation
    def _gen_candidate_locked(self):
        """A live instance a generation request may join right now:
        not mid cold-load, not exclusively held by one-shot work, with
        scheduler slot capacity.  Idle instances preferred (caller
        holds the lock).

        While an exclusive acquire() is blocked in wait() — or recently
        timed out and is being requeued/retried by the Router — no new
        joins are granted: a continuous stream of joiners would
        otherwise keep ``gen_count > 0`` forever and starve one-shot
        work on a saturated pool."""
        if self._excl_waiters > 0 or \
                time.monotonic() < self._excl_starved_until:
            return None
        for inst in list(self._idle) + list(self._busy):
            if not inst.live:
                continue
            gid = id(inst)
            if gid in self._gen_cold:
                continue                      # pipeline still loading it
            cnt = self._gen_count.get(gid, 0)
            if inst in self._busy and cnt == 0:
                continue                      # exclusive one-shot holder
            if cnt < getattr(inst, "gen_slots", 1):
                return inst
        return None

    def acquire_gen(self, *, timeout: Optional[float] = None,
                    logical_now: Optional[float] = None):
        """Reserve a *shared* generation hold.  Returns
        ``(inst, joinable)``:

          * joinable=True  — inst is live; the caller can join its
            decode scheduler immediately (other requests may already be
            resident: that co-residency is the continuous batch);
          * joinable=False — inst is cold and now held for this
            caller's pipeline load; the pool keeps other generation
            requests off it until :meth:`mark_live`.

        Preference order mirrors :meth:`acquire`: live instance with
        slot capacity, then a cold idle one, then scale-out up to
        ``max_instances``; otherwise block until something frees."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if logical_now is not None:
                    self._evict_expired_locked(logical_now)
                inst = self._gen_candidate_locked()
                if inst is not None:
                    gid = id(inst)
                    self._gen_count[gid] = self._gen_count.get(gid, 0) + 1
                    self._gen_changed_locked()
                    if inst in self._idle:
                        self._idle.remove(inst)
                        self._busy.append(inst)
                    return inst, True
                inst = next((i for i in self._idle if not i.live), None)
                if inst is not None:          # cold container: load here
                    self._idle.remove(inst)
                    self._busy.append(inst)
                    self._gen_count[id(inst)] = 1
                    self._gen_changed_locked()
                    self._gen_cold.add(id(inst))
                    return inst, False
                if len(self._instances) + self._creating \
                        < self.max_instances:
                    self._creating += 1
                    break
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"pool {self.model_name!r} saturated for "
                        f"generation ({self.max_instances} instances, "
                        f"all slots busy)")
                # nothing notifies when the exclusive-starvation window
                # lapses by itself (abandoned requester): cap the wait
                # at its expiry so joins resume then, not never
                window = self._excl_starved_until - time.monotonic()
                if window > 0:
                    remaining = window if remaining is None \
                        else min(remaining, window)
                self._cv.wait(remaining)
        return self._provision(gen=True), False

    def _provision(self, *, gen: bool = False):
        """Scale-out: build a fresh busy instance.  The caller already
        incremented ``_creating`` under the lock; the factory (builder +
        warmup) runs *outside* it so provisioning never serializes the
        pool.  ``gen=True`` registers the instance as cold-held by one
        generation request (closed to joiners until :meth:`mark_live`)."""
        try:
            inst = self._factory()
        except BaseException:
            with self._cv:
                self._creating -= 1
                self._cv.notify_all()
            raise
        with self._cv:
            self._creating -= 1
            self._instances.append(inst)
            self._busy.append(inst)
            if gen:
                self._gen_count[id(inst)] = 1
                self._gen_changed_locked()
                self._gen_cold.add(id(inst))
        return inst

    def _gen_changed_locked(self):
        self._m_gen.set(sum(self._gen_count.values()))

    def mark_live(self, inst):
        """The cold load on ``inst`` finished: open it to concurrent
        generation joiners (called mid-request via on_live)."""
        with self._cv:
            self._gen_cold.discard(id(inst))
            self._cv.notify_all()

    def _count_locked(self, cold: Optional[bool]):
        if cold is True:
            self._cold_starts += 1
            self._m_cold.inc()
        elif cold is False:
            self._warm_hits += 1
            self._m_warm.inc()

    def release_gen(self, inst, *, logical_now: float = 0.0,
                    cold: Optional[bool] = None):
        """Drop one shared generation hold; the instance returns to the
        idle list (keep-alive clock updated) when the last hold drops."""
        with self._cv:
            gid = id(inst)
            n = self._gen_count.get(gid, 0) - 1
            if n < 0:
                raise ValueError("release_gen without a matching hold")
            if n == 0:
                self._gen_count.pop(gid, None)
                self._gen_cold.discard(gid)
                self._busy.remove(inst)
                self._idle.append(inst)
            else:
                self._gen_count[gid] = n
            self._gen_changed_locked()
            self._last_used[gid] = max(
                self._last_used.get(gid, 0.0), logical_now)
            self._count_locked(cold)
            self._cv.notify_all()

    def release(self, inst, *, logical_now: float = 0.0,
                cold: Optional[bool] = None):
        with self._cv:
            if inst not in self._busy:
                raise ValueError("release of an instance not acquired")
            self._busy.remove(inst)
            self._idle.append(inst)
            # out-of-order completions must not move the keep-alive
            # clock backwards (a logically-older request finishing late)
            self._last_used[id(inst)] = max(
                self._last_used.get(id(inst), 0.0), logical_now)
            self._count_locked(cold)
            self._cv.notify_all()

    def _evict_expired_locked(self, now: float) -> int:
        """Offer idle live instances to the eviction policy (caller
        holds the lock); returns the number evicted."""
        n = 0
        for inst in self._idle:
            if not inst.live:
                continue
            idle_s = now - self._last_used.get(id(inst), now)
            if self.policy.should_evict(idle_s):
                inst.evict()
                n += 1
        self._evictions += n
        if n:
            self._m_evict.inc(n)
        return n

    def sweep(self, now: float) -> int:
        """Run keep-alive eviction over idle live instances; returns the
        number evicted.  Busy instances are never considered."""
        with self._cv:
            return self._evict_expired_locked(now)

    # ----------------------------------------------------------- scaling
    def prewarm(self, *, logical_now: Optional[float] = None) -> bool:
        """Provision one warm instance *off the request path* (a
        scale-out action).  Reuses a cold idle container when one
        exists, else scales out up to ``max_instances``; the cold-start
        pipeline then runs on the caller's thread while the pool stays
        unlocked, and the warmed instance returns to the idle list.
        Returns True when an instance was warmed, False when the pool
        had no capacity or was already fully warm."""
        created = False
        with self._cv:
            inst = next((i for i in self._idle if not i.live), None)
            if inst is not None:
                self._idle.remove(inst)
                self._busy.append(inst)
            elif len(self._instances) + self._creating \
                    < self.max_instances:
                self._creating += 1
                created = True
            else:
                return False
        if created:
            inst = self._provision()
        try:
            ensure = getattr(inst, "ensure_live", None)
            warmed = ensure() if ensure is not None else created
        except BaseException:
            # failed load: hand the (still cold) container back so a
            # real request can retry the pipeline with its own batch
            self.release(inst, logical_now=logical_now or 0.0)
            raise
        # cold=None: a prewarm is capacity provisioning, not a served
        # request — it must not count as a cold start or warm hit
        self.release(inst, logical_now=logical_now or 0.0)
        if warmed or created:
            with self._cv:
                self._prewarms += 1
            self._m_prewarm.inc()
            return True
        return False

    def scale_in(self, keep: int, *, now: float = 0.0) -> int:
        """Evict idle live instances until at most ``keep`` live
        instances remain (a scale-in action).  Only *idle* instances are
        touched: busy instances — including every instance holding
        resident generations, which live on the busy list until their
        last shared hold drops — are out of reach.  Returns the number
        evicted."""
        keep = max(0, int(keep))
        with self._cv:
            excess = sum(1 for i in self._instances if i.live) - keep
            n = 0
            for inst in list(self._idle):
                if excess <= 0:
                    break
                if not inst.live:
                    continue
                inst.evict()
                self._last_used.pop(id(inst), None)
                n += 1
                excess -= 1
            self._evictions += n
            if n:
                self._m_evict.inc(n)
            return n

    # -------------------------------------------------------------- queries
    def any_live(self) -> bool:
        """True when some instance holds params (a request routed here
        is warm-servable -> INFERENCE class)."""
        with self._cv:
            return any(i.live for i in self._instances)

    def stats(self) -> PoolStats:
        with self._cv:
            return PoolStats(model=self.model_name,
                             size=len(self._instances),
                             live=sum(1 for i in self._instances if i.live),
                             busy=len(self._busy),
                             cold_starts=self._cold_starts,
                             warm_hits=self._warm_hits,
                             evictions=self._evictions,
                             gen_active=sum(self._gen_count.values()),
                             prewarms=self._prewarms)
