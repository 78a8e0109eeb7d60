"""Cluster-wide placement table: where every ``(model, unit, shard)``
has landed, and who may read it from the origin store.

The table is the cluster's single point of coordination.  It answers
two questions:

  * **locality** — which nodes hold a model's units right now
    (:meth:`nodes_for_model` feeds the front-end router's placement
    score; :meth:`locate` feeds the peer-exchange tier);
  * **cluster-wide single-flight** — when N nodes cold-start the same
    key at once, :meth:`begin_fetch` elects exactly one origin-store
    *leader* per key; everyone else waits on the table's condition
    variable and is redirected to a peer once the leader publishes.
    With the per-node WeightCache (which single-flights *within* a
    node), an N-way scale-out burst does at most **one** origin read
    per key, cluster-wide — the rest moves over the intra-cluster link.

State machine per key (all transitions under ``_cv``):

    absent --begin_fetch--> loading(leader)
    loading --publish--> held(leader)          waiters wake -> PEER
    loading --abort--> absent                  waiters wake -> re-elect
    held --drop (cache eviction)--> absent (when the last holder drops)

Entries never go stale silently: every node's WeightCache carries an
``on_evict`` callback that calls :meth:`drop`, so a PEER answer is at
worst *transiently* wrong (an eviction racing the fetch) — the peer tier
handles that by dropping the dead holder and retrying begin_fetch, which
eventually degrades to an ORIGIN read.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Tuple

from repro_torch import analysis

# begin_fetch() outcomes
ORIGIN = "origin"   # caller elected leader: read the origin store, then
                    # publish() (or abort() on failure)
PEER = "peer"       # a holder exists: stream from the returned node

Key = Tuple[str, str, Hashable]


class PlacementTable:
    """Thread-safe cluster-wide ``key -> holders`` map with leader
    election for origin reads (cluster-wide single-flight)."""

    def __init__(self):
        self._cv = analysis.make_condition("PlacementTable._cv")
        # key -> node ids holding the key (insertion order = landing order)
        self._holders: Dict[Key, List[str]] = {}     # guarded-by: _cv
        # key -> node id currently leading the origin read
        self._loading: Dict[Key, str] = {}           # guarded-by: _cv
        self._origin_elections = 0                   # guarded-by: _cv
        self._peer_referrals = 0                     # guarded-by: _cv
        self._waits = 0                              # guarded-by: _cv

    # ------------------------------------------------------ fetch protocol
    def begin_fetch(self, node: str, model: str, unit: str,
                    shard: Hashable = 0) -> Tuple[str, Optional[str]]:
        """Ask where ``node`` should read this key from.

        Returns ``(ORIGIN, None)`` — the caller is the cluster-wide
        leader and must read the origin store, then :meth:`publish` (or
        :meth:`abort`) — or ``(PEER, holder)`` — stream from that node's
        cache.  While another node leads the origin read the caller
        blocks here; on publish it is redirected to the fresh holder, on
        abort one waiter is re-elected leader.
        """
        key = (model, unit, shard)
        with self._cv:
            waited = False
            while True:
                holders = self._holders.get(key)
                if holders:
                    # prefer a holder that is not the asking node: the
                    # asker's own cache already missed (a self-referral
                    # can happen when its eviction raced this fetch)
                    peer = next((h for h in holders if h != node),
                                holders[0])
                    self._peer_referrals += 1
                    return PEER, peer
                if key not in self._loading:
                    self._loading[key] = node
                    self._origin_elections += 1
                    return ORIGIN, None
                if not waited:
                    waited = True
                    self._waits += 1
                self._cv.wait()

    def publish(self, node: str, model: str, unit: str,
                shard: Hashable = 0):
        """``node``'s copy of the key is resident (its cache completed
        the entry): record it and wake begin_fetch waiters."""
        key = (model, unit, shard)
        with self._cv:
            holders = self._holders.setdefault(key, [])
            if node not in holders:
                holders.append(node)
            if self._loading.get(key) == node:
                del self._loading[key]
            self._cv.notify_all()

    def abort(self, node: str, model: str, unit: str, shard: Hashable = 0):
        """``node``'s origin read failed (or it never led): release the
        leadership claim so a waiter is re-elected.  Idempotent."""
        key = (model, unit, shard)
        with self._cv:
            if self._loading.get(key) == node:
                del self._loading[key]
                self._cv.notify_all()

    def drop(self, node: str, model: str, unit: str, shard: Hashable = 0):
        """``node`` no longer holds the key (a cache eviction — wired to
        ``WeightCache(on_evict=...)`` — or a stale-referral repair)."""
        key = (model, unit, shard)
        with self._cv:
            holders = self._holders.get(key)
            if holders and node in holders:
                holders.remove(node)
                if not holders:
                    del self._holders[key]

    # -------------------------------------------------------------- queries
    def locate(self, model: str, unit: str, shard: Hashable = 0
               ) -> List[str]:
        """Node ids currently holding the key (landing order)."""
        with self._cv:
            return list(self._holders.get((model, unit, shard), ()))

    def nodes_for_model(self, model: str) -> Dict[str, int]:
        """node id -> number of this model's keys it holds — the
        locality term of the front-end router's placement score."""
        with self._cv:
            out: Dict[str, int] = {}
            for (m, _u, _s), holders in self._holders.items():
                if m != model:
                    continue
                for h in holders:
                    out[h] = out.get(h, 0) + 1
            return out

    def snapshot(self) -> Dict[str, object]:
        """Observability view: per-model key / holder counts plus the
        single-flight counters (how much origin traffic the table
        deduplicated)."""
        with self._cv:
            models: Dict[str, Dict[str, int]] = {}
            for (m, _u, _s), holders in self._holders.items():
                rec = models.setdefault(m, {"keys": 0, "copies": 0})
                rec["keys"] += 1
                rec["copies"] += len(holders)
            return {"models": models,
                    "loading": len(self._loading),
                    "origin_elections": self._origin_elections,
                    "peer_referrals": self._peer_referrals,
                    "waits": self._waits}

    def clear(self):
        """Forget every placement (tests / benchmark flushes).  In-flight
        leadership claims are kept: clearing mid-load must not re-elect a
        second origin reader for the same key."""
        with self._cv:
            self._holders.clear()
            self._cv.notify_all()
