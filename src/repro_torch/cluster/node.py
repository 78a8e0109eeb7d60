"""One simulated cluster node: a full single-node serving stack —
private :class:`~repro_torch.serving.pool.InstancePool` s behind a
private Router, a private :class:`~repro_torch.store.cache.WeightCache`,
a private metrics registry — plus the node's membership in the cluster:
its cache publishes and withdraws placement-table entries, and its
cold-start retrieval streams read through a
:class:`~repro_torch.cluster.peer.ClusterShardSource` (peer exchange)
instead of always hitting the origin store.

Everything inside the node is exactly the single-node platform
(``ServerlessPlatform``); the node only *wires* it into the cluster:

  * ``WeightCache(on_evict=...)`` → ``PlacementTable.drop`` — a dropped
    unit is withdrawn from the placement table at once, so peer
    referrals cannot point at evicted bytes for long;
  * every ``cache.complete`` of a leader read is followed (by the
    decoupler) with ``source.publish`` → ``PlacementTable.publish`` —
    the moment a unit lands it can serve every other node;
  * :meth:`serve_shard` / :meth:`end_serve` are the peer-facing read
    path: a pinned, non-blocking cache peek (``try_get``), so a remote
    fetch can never become this cache's load leader and the entry
    cannot be evicted mid-transfer.

All nodes of a cluster share one process and one device: their cold
starts share the card, the interpreter and the kernel registry's
launch counts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional

from repro_torch import metrics as metrics_mod
from repro_torch.cluster.peer import ClusterShardSource
from repro_torch.cluster.placement import PlacementTable
from repro_torch.serving.engine import ServerlessPlatform
from repro_torch.store.cache import WeightCache
from repro_torch.store.store import BandwidthModel, WeightStore


class Node:
    """One cluster node: node-local serving platform + cluster wiring."""

    def __init__(self, node_id: str, index: int, store: WeightStore,
                 builders: Dict[str, Callable[[], tuple]], *,
                 placement: PlacementTable,
                 link: Optional[BandwidthModel] = None,
                 resolve_peer: Optional[
                     Callable[[str], Optional["Node"]]] = None,
                 cache_budget_bytes: int = 0,
                 peer_exchange: bool = True,
                 chunk_bytes: int = 1 << 20,
                 **platform_kw):
        """``store``: the *shared* origin store (all nodes contend on its
        BandwidthModel — the slow pipe peer exchange avoids).
        ``link`` / ``resolve_peer``: the shared intra-cluster link and
        the node directory, both owned by the ClusterPlatform.
        ``peer_exchange=False`` keeps the node cluster-blind (its cold
        starts always read the origin) — the baseline peer exchange is
        measured against.  Remaining kwargs go to this node's
        ServerlessPlatform (strategy, keep_alive_s, max_instances,
        gen_slots, device, ...)."""
        self.node_id = node_id
        self.index = int(index)
        self.placement = placement
        self.metrics = metrics_mod.MetricsRegistry()
        self.cache = WeightCache(cache_budget_bytes,
                                 metrics=self.metrics,
                                 on_evict=self._on_evict)
        self.source: Optional[ClusterShardSource] = None
        if peer_exchange:
            self.source = ClusterShardSource(
                node_id, placement, link,
                resolve_peer or (lambda _nid: None),
                channel=self.index, chunk_bytes=chunk_bytes,
                metrics=self.metrics)
        self.platform = ServerlessPlatform(
            store, builders, cache=self.cache, metrics=self.metrics,
            source=self.source, chunk_bytes=chunk_bytes, **platform_kw)
        self._m_peer_served = self.metrics.counter("cluster/peer_served")

    # --------------------------------------------------- placement wiring
    def _on_evict(self, key):
        """WeightCache eviction hook (runs outside the cache lock):
        withdraw the dropped unit from the placement table."""
        model, unit, shard = key
        self.placement.drop(self.node_id, model, unit, shard)

    # ------------------------------------------------------ peer-facing read
    def serve_shard(self, model: str, unit: str, skey: Hashable = 0
                    ) -> Optional[Any]:
        """A peer's transfer source: this node's cached payload with a
        reference pinned (call :meth:`end_serve` after the transfer), or
        None when the key is absent or loading — the *stale referral*
        signal; the asker repairs the placement table and falls back."""
        payload = self.cache.try_get(model, unit, skey)
        if payload is not None:
            self._m_peer_served.inc()
        return payload

    def end_serve(self, model: str, unit: str, skey: Hashable = 0):
        self.cache.release(model, unit, skey)

    # ------------------------------------------------------------- queries
    def any_live(self, model: str) -> bool:
        """A live instance of ``model`` on this node (warm-servable)."""
        pool = self.platform.pools.get(model)
        return pool is not None and pool.any_live()

    def load_score(self) -> float:
        """The placement load term: requests in service + queued on this
        node, read from the live gauges :meth:`metrics_snapshot` exports
        (``router/in_flight`` + ``router/queue_depth``)."""
        g = self.metrics.gauge
        return g("router/in_flight").value + g("router/queue_depth").value

    def origin_reads(self) -> float:
        """Cumulative origin-store reads this node performed as a
        cluster-wide single-flight leader (peer-served streams do not
        count — that is the point)."""
        return self.metrics.counter("cluster/origin_reads").value

    def peer_reads(self) -> float:
        return self.metrics.counter("cluster/peer_reads").value

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The per-node observability surface (this node's private
        registry) — aggregated by ClusterPlatform.cluster_snapshot."""
        return self.platform.metrics_snapshot()

    # ------------------------------------------------------------ lifecycle
    def router(self, *, workers: int = 4, max_pending: Optional[int] = None):
        """This node's Router (the cluster front end creates one per node
        and places requests across them)."""
        return self.platform.router(workers=workers,
                                    max_pending=max_pending)

    def sweep(self, logical_now: float) -> int:
        return self.platform.sweep(logical_now)

    def flush(self) -> None:
        """Back to cold (benchmarks / tests): evict every idle live
        instance and drop all cached weights — the on-evict hook
        withdraws this node's placement entries as a side effect."""
        for pool in self.platform.pools.values():
            pool.scale_in(0)
        self.cache.clear()
