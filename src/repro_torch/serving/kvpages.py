"""Block-paged KV memory: the :class:`KVPagePool` page allocator, a port
of ``repro.serving.kvpages`` (host bookkeeping only; no tensors).

The slotted decode arena (``init_cache(n_slots, cache_len)``) sized
every slot for the longest request; paged KV splits decode memory into
fixed-size **pages** of ``page_tokens`` positions and gives each
resident request a *page table* instead of a contiguous slot.  This
module is the host-side bookkeeping half — the device arrays (one
``(n_pages, K, page_tokens, dh)`` pool per attention layer) are owned
by the :class:`~repro_torch.serving.decode.DecodeScheduler`, which consults
this pool for every allocate / share / free decision.

Disciplines (the serving-side twin of the WeightCache, now for KV):

  * **byte-budgeted** — ``n_pages`` is derived from a byte budget and
    the per-page footprint across all attention layers; admission
    reserves whole pages up front (all-or-nothing, so two half-admitted
    requests can never deadlock each other) and overflow is *blocking
    backpressure*, not an error — :class:`CacheOverflowError` is raised
    only when a request could never fit the whole budget.
  * **refcounted sharing** — pages are content-addressed by a running
    (model, token-prefix) hash over *full* prompt pages.  Requests that
    share a system prompt pin the same physical pages
    (:meth:`match_prefix`), so a prefix hit skips that span of prefill
    entirely and TTFT drops to the unshared suffix.
  * **cached free list** — a released page whose content is registered
    in the prefix index is parked in an LRU side list instead of being
    scrubbed: later requests still hit it warm, and the allocator
    evicts LRU-first only under pressure.
  * **copy-on-write append** — :meth:`ensure_writable` forks a shared
    page before a writer may touch it.  (The scheduler's layout makes
    decode writes land past every shared page, so this is a guard rail
    plus a unit-tested primitive, not a hot path.)

Locking: one condition variable guards all state (made by
:mod:`repro_torch.analysis`).  The pool is a *leaf* in the lock order — it
never calls out while holding its lock.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import analysis, metrics as metrics_mod
from repro_torch.serving.api import CacheOverflowError


def page_hashes(key: str, tokens, page_tokens: int) -> List[str]:
    """Running content hash per *full* page of ``tokens``.

    ``hashes[i]`` commits to pages ``0..i`` inclusive (a running hash:
    page i's digest folds in page i-1's), prefixed by ``key`` — the
    model identity — so equal token prefixes under different models
    never collide.  Partial trailing pages are not hashed: only pages
    whose every position is prompt content are shareable.
    """
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out: List[str] = []
    h = hashlib.sha1(key.encode())
    for p in range(len(toks) // page_tokens):
        h = h.copy()
        h.update(toks[p * page_tokens:(p + 1) * page_tokens].tobytes())
        out.append(h.hexdigest())
    return out


@dataclasses.dataclass
class KVPageStats:
    """Point-in-time pool occupancy."""
    total: int              # page budget
    used: int               # pages holding live content (pinned + cached)
    pinned: int             # pages held by >= 1 resident request
    cached: int             # released pages kept warm for prefix hits
    free: int               # immediately allocatable (excludes cached)
    prefix_hits: int        # cumulative pages served from the prefix index
    prefix_misses: int      # cumulative lookups that found no next page
    cow_copies: int         # cumulative copy-on-write forks


class KVPagePool:
    """Thread-safe refcounted allocator over ``n_pages`` logical pages.

    Page ids are ``0..n_pages-1``; the device-side pool arrays carry one
    extra *scratch* page (id :attr:`scratch_id`) that inactive decode
    rows write into — it is never handed out here.
    """

    def __init__(self, *, n_pages: int, page_tokens: int,
                 page_bytes: int = 0, model_key: str = "",
                 metrics: Optional[metrics_mod.MetricsRegistry] = None):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_tokens < 1:
            raise ValueError(
                f"page_tokens must be >= 1, got {page_tokens}")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self.page_bytes = int(page_bytes)
        self.model_key = model_key
        self.scratch_id = self.n_pages
        self._cv = analysis.make_condition("KVPagePool._cv")
        self._free: List[int] = list(range(self.n_pages))  # guarded-by: _cv
        self._ref: Dict[int, int] = {}                     # guarded-by: _cv
        # prefix index: running-hash -> page id, and its inverse for
        # invalidation on evict/recycle
        self._by_hash: Dict[str, int] = {}                 # guarded-by: _cv
        self._hash_of: Dict[int, str] = {}                 # guarded-by: _cv
        # released-but-registered pages, LRU order (oldest first)
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # guarded-by: _cv
        self.prefix_hits = 0                               # guarded-by: _cv
        self.prefix_misses = 0                             # guarded-by: _cv
        self.cow_copies = 0                                # guarded-by: _cv
        m = metrics_mod.resolve(metrics)
        self._m_total = m.gauge("kv/pages_total")
        self._m_used = m.gauge("kv/pages_used")
        self._m_pinned = m.gauge("kv/pages_pinned")
        self._m_hits = m.counter("kv/prefix_hits")
        self._m_misses = m.counter("kv/prefix_misses")
        self._m_total.set(self.n_pages)
        self._m_used.set(0)
        self._m_pinned.set(0)

    # ------------------------------------------------------------- internals
    def _available_locked(self) -> int:
        return len(self._free) + len(self._cached)

    def _gauges_locked(self):
        # metric instruments are leaf locks: safe to update under _cv
        self._m_used.set(self.n_pages - len(self._free))
        self._m_pinned.set(len(self._ref))

    def _forget_locked(self, pid: int):
        """Drop ``pid`` from the prefix index (content being recycled)."""
        h = self._hash_of.pop(pid, None)
        if h is not None and self._by_hash.get(h) == pid:
            del self._by_hash[h]

    def _take_locked(self, n: int) -> List[int]:
        """Pop ``n`` pages, evicting cached LRU pages as needed."""
        ids: List[int] = []
        for _ in range(n):
            if self._free:
                ids.append(self._free.pop())
            else:
                pid, _ = self._cached.popitem(last=False)   # LRU eviction
                self._forget_locked(pid)
                ids.append(pid)
        for pid in ids:
            self._ref[pid] = 1
        return ids

    # ------------------------------------------------------------ allocation
    def alloc(self, n: int, *, timeout: Optional[float] = None) -> List[int]:
        """Reserve ``n`` pages (refcount 1 each), blocking while the pool
        is under pressure.  All-or-nothing: a caller never holds a
        partial reservation while waiting, so concurrent admissions
        cannot deadlock.  Raises :class:`CacheOverflowError` if ``n``
        exceeds the whole budget (can *never* fit) and ``TimeoutError``
        if the pool stays exhausted past ``timeout`` seconds.
        """
        n = int(n)
        if n > self.n_pages:
            raise CacheOverflowError(
                f"request needs {n} KV pages but the pool budget is "
                f"{self.n_pages} pages x {self.page_tokens} tokens")
        if n <= 0:
            return []
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._available_locked() < n:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no free KV pages: need {n}, "
                            f"{self._available_locked()} available "
                            f"of {self.n_pages}")
                self._cv.wait(remaining)
            ids = self._take_locked(n)
            self._gauges_locked()
            return ids

    def release(self, ids: Sequence[int]):
        """Drop one reference per page.  A page reaching refcount 0 goes
        to the cached LRU if its content is registered (warm prefix
        reuse) or straight back to the free list otherwise."""
        with self._cv:
            for pid in ids:
                r = self._ref.get(pid, 0) - 1
                if r > 0:
                    self._ref[pid] = r
                    continue
                self._ref.pop(pid, None)
                if pid in self._hash_of:
                    self._cached[pid] = None
                    self._cached.move_to_end(pid)
                else:
                    self._free.append(pid)
            self._gauges_locked()
            self._cv.notify_all()

    # -------------------------------------------------------- prefix sharing
    def register(self, pid: int, h: str):
        """Publish ``pid`` as holding the prefix content ``h``.  Must be
        called only after the page's device content is final (the
        scheduler registers at the join boundary, after packing).
        First writer wins: a hash already mapped to a live page keeps
        its existing mapping (dedup point for future requests)."""
        with self._cv:
            if pid not in self._ref and pid not in self._cached:
                return                     # freed before registration landed
            if h in self._by_hash:
                return
            self._forget_locked(pid)       # one hash per page
            self._by_hash[h] = pid
            self._hash_of[pid] = h

    def match_prefix(self, hashes: Sequence[str]) -> List[int]:
        """Longest-prefix lookup: walk the running hashes in order and
        pin (incref) each page found; stop at the first miss.  Returns
        the pinned page ids — the caller owns one reference on each and
        must :meth:`release` them eventually."""
        out: List[int] = []
        with self._cv:
            for h in hashes:
                pid = self._by_hash.get(h)
                if pid is None:
                    self.prefix_misses += 1
                    self._m_misses.inc()
                    break
                if pid in self._cached:          # revive from the LRU
                    del self._cached[pid]
                self._ref[pid] = self._ref.get(pid, 0) + 1
                self.prefix_hits += 1
                self._m_hits.inc()
                out.append(pid)
            self._gauges_locked()
        return out

    def ensure_writable(self, pid: int):
        """Copy-on-write guard: returns ``(pid, False)`` when the caller
        holds the only reference, else forks — allocates a fresh page
        (non-blocking: raises :class:`CacheOverflowError` under
        exhaustion rather than waiting while the caller may hold other
        locks), drops the caller's reference on the shared page and
        returns ``(new_pid, True)``.  The caller must then copy the
        device content old -> new before writing."""
        with self._cv:
            if self._ref.get(pid, 0) <= 1:
                return pid, False
            if self._available_locked() < 1:
                raise CacheOverflowError(
                    "copy-on-write fork needs a free KV page but the "
                    f"pool is exhausted ({self.n_pages} pages, all live)")
            new = self._take_locked(1)[0]
            # drop our reference on the shared original
            self._ref[pid] -= 1
            self.cow_copies += 1
            self._gauges_locked()
            return new, True

    # ------------------------------------------------------------------ info
    def stats(self) -> KVPageStats:
        with self._cv:
            return KVPageStats(
                total=self.n_pages,
                used=self.n_pages - len(self._free),
                pinned=len(self._ref),
                cached=len(self._cached),
                free=len(self._free),
                prefix_hits=self.prefix_hits,
                prefix_misses=self.prefix_misses,
                cow_copies=self.cow_copies)

    def check_invariants(self):
        """Every page is in exactly one of {free, cached, pinned}; the
        prefix index maps only live pages.  Storm tests call this
        between operations."""
        with self._cv:
            free = set(self._free)
            cached = set(self._cached)
            pinned = set(self._ref)
            assert not (free & cached) and not (free & pinned) \
                and not (cached & pinned), (free, cached, pinned)
            assert free | cached | pinned == set(range(self.n_pages)), \
                "page leak/duplication"
            assert all(r > 0 for r in self._ref.values())
            for h, pid in self._by_hash.items():
                assert self._hash_of.get(pid) == h
                assert pid in cached or pid in pinned
