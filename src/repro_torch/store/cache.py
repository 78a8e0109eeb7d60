"""Node-local shared WeightCache: retrieved unit leaves, reused across
cold starts (a port of ``repro.store.cache``).

Under scale-out every instance of the same model would re-read its full
weight extents from the store — the dominant cold-start cost paid N
times on one node.  This cache is the reuse point:

  * **keyed by (model, unit, shard)** — the store's retrieval
    granularity: ``shard=0`` for a unit-granular stream, ``(mesh_tag,
    shard)`` for a shard stream of a mesh cold start;
  * **single-flight** — the first loader of a unit reads from the
    store, every concurrent loader blocks on the shared condition
    variable and receives the leader's leaves: one physical read per
    unit, node-wide, no matter how many instances cold-start at once;
  * **byte-budgeted, priority-aware eviction** — LRU over unpinned
    entries, and units of models with a load currently in flight are
    spared outright (the WeightDecoupler registers its load and pins
    each unit from retrieval until weight application, so a unit needed
    by an in-flight — possibly Algorithm-1-critical — load is never
    evicted under pressure; the budget is re-enforced when loads
    retire);
  * **refcounted pins** — ``begin``/``complete`` take a reference,
    ``release`` drops it; pinned entries are never evicted (the budget
    may transiently overshoot while pins are held — pins are the short
    retrieval->application window of a load).

Entries hold the leaf dict exactly as ``WeightStore.deserialize``
returns it: host tensors that are views into the unit's read buffer —
pinned memory on a GPU host — with int8 leaves still quantized, so
dequantization stays the per-load weight-application phase and a cache
hit skips the read, crc and deserialize only; a shard entry holds the
shard stream's pieces (host slices, int8 with their scale slices).  An
entry's ``nbytes`` is the stream's store bytes.  A pin is released once
the load's application of the unit has completed on the card (the weight
unit waits for its CUDA event, which follows every shard lane's copies,
before it checks in), so an evicted buffer is never the source of a copy
still in flight.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import (Any, Callable, Dict, Hashable, List, Optional, Tuple)

from repro_torch import analysis, metrics as metrics_mod

# begin() outcomes
HIT = "hit"      # leaves returned, reference taken
LOAD = "load"    # caller is the leader: read the store, then complete()/abort()


@dataclasses.dataclass
class CacheStats:
    """Point-in-time + cumulative counters (thread-safe snapshot)."""
    budget_bytes: Optional[int]
    bytes_cached: int = 0
    entries: int = 0
    pinned: int = 0
    hits: int = 0            # begin() served from cache (incl. after a wait)
    misses: int = 0          # begin() promoted the caller to leader
    waits: int = 0           # hits that waited on another loader (deduped I/O)
    inserts: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class _Entry:
    __slots__ = ("leaves", "nbytes", "refs", "loading")

    def __init__(self):
        self.leaves: Any = None
        self.nbytes = 0
        self.refs = 0
        self.loading = True


class WeightCache:
    """Thread-safe node-level cache of deserialized unit leaves.

    ``budget_bytes=None`` (or ``0``) means unbounded; a positive
    integer bounds the bytes of *unpinned* residency (pinned entries
    and in-flight models may transiently overshoot).
    """

    def __init__(self, budget_bytes: Optional[int] = None, *,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None,
                 on_evict: Optional[
                     Callable[[Tuple[str, str, Hashable]], None]] = None):
        """``on_evict``: called with each evicted ``(model, unit,
        shard)`` key, *outside* the cache lock (so the callback may
        take other locks — e.g. a cluster placement table — without
        creating a WeightCache._cv -> X lock-order edge).  The entry is
        already gone when the callback runs; a concurrent ``begin`` of
        the same key re-loads it, so consumers must treat the signal as
        "may be stale", not "is absent forever"."""
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0 or None")
        # 0 -> unbounded, matching the platform's cache_budget_bytes
        # knob (a literal zero-byte cache would evict every entry on
        # insert — never what a caller wants from "enable the cache")
        self.budget_bytes = budget_bytes or None
        self.on_evict = on_evict
        self._cv = analysis.make_condition("WeightCache._cv")
        self._entries: "OrderedDict[Tuple[str, str, Hashable], _Entry]" \
            = OrderedDict()                      # guarded-by: _cv
        self._bytes = 0                          # guarded-by: _cv
        self._inflight: Dict[str, int] = {}      # guarded-by: _cv
        self._hits = 0                           # guarded-by: _cv
        self._misses = 0                         # guarded-by: _cv
        self._waits = 0                          # guarded-by: _cv
        self._inserts = 0                        # guarded-by: _cv
        self._evictions = 0                      # guarded-by: _cv
        m = metrics_mod.resolve(metrics)
        # leaf-lock instruments: safe to inc while holding _cv
        self._m_hits = m.counter("weight_cache/hits")
        self._m_misses = m.counter("weight_cache/misses")
        self._m_waits = m.counter("weight_cache/waits")
        self._m_evictions = m.counter("weight_cache/evictions")
        self._m_bytes = m.gauge("weight_cache/bytes")

    # --------------------------------------------------------- load protocol
    def begin(self, model: str, unit: str, shard: Hashable = 0
              ) -> Tuple[str, Any]:
        """Enter the single-flight protocol for one (unit, shard).

        Returns ``(HIT, leaves)`` — a reference is taken; call
        :meth:`release` after the weight-application phase — or
        ``(LOAD, None)`` — the caller is the leader and must read the
        store, then call :meth:`complete` (which also takes the
        leader's reference) or :meth:`abort` on failure.  Concurrent
        callers of a loading unit block here and are served the
        leader's result (or promoted to leader if it aborts).
        """
        key = (model, unit, shard)
        waited = False
        with self._cv:
            while True:
                e = self._entries.get(key)
                if e is None:
                    e = _Entry()
                    self._entries[key] = e
                    self._misses += 1
                    self._m_misses.inc()
                    return LOAD, None
                if e.loading:
                    waited = True
                    self._cv.wait()
                    continue
                e.refs += 1
                self._entries.move_to_end(key)
                self._hits += 1
                self._m_hits.inc()
                if waited:
                    self._waits += 1
                    self._m_waits.inc()
                return HIT, e.leaves

    def try_get(self, model: str, unit: str, shard: Hashable = 0
                ) -> Optional[Any]:
        """Non-blocking peek: the entry's leaves with a reference taken
        (pair with :meth:`release`), or None when absent *or* loading.
        Unlike :meth:`begin` this never promotes the caller to leader
        and never waits — it is the peer-serving read (a remote node
        asking "do you hold this shard right now?"): a miss must fall
        back to its own source, not start a load on *this* cache."""
        with self._cv:
            e = self._entries.get((model, unit, shard))
            if e is None or e.loading:
                return None
            e.refs += 1
            self._entries.move_to_end((model, unit, shard))
            return e.leaves

    def complete(self, model: str, unit: str, leaves: Any, nbytes: int,
                 shard: Hashable = 0):
        """Publish the leader's read; wakes all waiters.  The leader
        keeps one reference (release after application)."""
        key = (model, unit, shard)
        with self._cv:
            e = self._entries.get(key)
            if e is None or not e.loading:
                raise RuntimeError(f"complete() without begin(): {key}")
            e.leaves = leaves
            e.nbytes = int(nbytes)
            e.refs = 1
            e.loading = False
            self._bytes += e.nbytes
            self._inserts += 1
            self._entries.move_to_end(key)
            evicted = self._evict_locked()
            self._m_bytes.set(self._bytes)
            self._cv.notify_all()
        self._notify_evicted(evicted)

    def abort(self, model: str, unit: str, shard: Hashable = 0):
        """Leader failed: drop the placeholder so a waiter retries as
        the new leader."""
        with self._cv:
            e = self._entries.get((model, unit, shard))
            if e is not None and e.loading:
                del self._entries[(model, unit, shard)]
            self._cv.notify_all()

    def release(self, model: str, unit: str, shard: Hashable = 0):
        """Drop one reference taken by begin()/complete()/try_get()."""
        with self._cv:
            e = self._entries.get((model, unit, shard))
            if e is None or e.loading:
                return
            e.refs = max(0, e.refs - 1)
            evicted = self._evict_locked()
        self._notify_evicted(evicted)

    # --------------------------------------------- in-flight load registry
    def register_load(self, model: str):
        """A cold-start load of ``model`` is in flight: its cached
        units are spared by eviction until idle models' units are gone."""
        with self._cv:
            self._inflight[model] = self._inflight.get(model, 0) + 1

    def unregister_load(self, model: str):
        with self._cv:
            n = self._inflight.get(model, 0) - 1
            if n > 0:
                self._inflight[model] = n
            else:
                self._inflight.pop(model, None)
            evicted = self._evict_locked()
        self._notify_evicted(evicted)

    # -------------------------------------------------------------- eviction
    def _evict_locked(self) -> List[Tuple[str, str, Hashable]]:
        """LRU over evictable entries; returns the evicted keys (the
        caller fires ``on_evict`` after dropping the lock).  Never
        touched: loading slots, pinned entries (refs > 0), and units of
        models with a registered in-flight load — the budget may
        transiently overshoot while pins/loads are held; it is
        re-enforced on release()/unregister_load()."""
        evicted: List[Tuple[str, str, Hashable]] = []
        if self.budget_bytes is None:
            return evicted
        for key in list(self._entries):
            if self._bytes <= self.budget_bytes:
                return evicted
            e = self._entries[key]
            if e.loading or e.refs > 0 or key[0] in self._inflight:
                continue
            del self._entries[key]
            self._bytes -= e.nbytes
            self._evictions += 1
            self._m_evictions.inc()
            self._m_bytes.set(self._bytes)
            evicted.append(key)
        return evicted

    def _notify_evicted(self, keys: List[Tuple[str, str, Hashable]]):
        if self.on_evict is None:
            return
        for key in keys:
            self.on_evict(key)

    # --------------------------------------------------------------- queries
    def __contains__(self, key: Tuple) -> bool:
        # 2-tuples address the default (unit-granular) shard 0
        if len(key) == 2:
            key = (key[0], key[1], 0)
        with self._cv:
            e = self._entries.get(key)
            return e is not None and not e.loading

    def cached_units(self, model: str) -> List[str]:
        """Unit names with at least one cached shard."""
        with self._cv:
            seen = []
            for (m, u, _s), e in self._entries.items():
                if m == model and not e.loading and u not in seen:
                    seen.append(u)
            return seen

    def stats(self) -> CacheStats:
        with self._cv:
            return CacheStats(
                budget_bytes=self.budget_bytes,
                bytes_cached=self._bytes,
                entries=sum(1 for e in self._entries.values()
                            if not e.loading),
                pinned=sum(1 for e in self._entries.values()
                           if not e.loading and e.refs > 0),
                hits=self._hits, misses=self._misses, waits=self._waits,
                inserts=self._inserts, evictions=self._evictions)

    def clear(self):
        """Drop every unpinned, non-loading entry (tests / redeploys)."""
        dropped = []
        with self._cv:
            for key in list(self._entries):
                e = self._entries[key]
                if e.loading or e.refs > 0:
                    continue
                del self._entries[key]
                self._bytes -= e.nbytes
                dropped.append(key)
        self._notify_evicted(dropped)
