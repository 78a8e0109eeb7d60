"""Cluster-scale serving: N simulated :class:`~repro_torch.cluster.node.
Node` s behind a locality-aware front-end router, coordinated by one
:class:`~repro_torch.cluster.placement.PlacementTable` and one
intra-cluster link for peer-to-peer weight exchange.

:class:`ClusterPlatform` is the multi-node sibling of
:class:`~repro_torch.serving.engine.ServerlessPlatform` — the same
surface (``router`` / ``run_trace`` / ``sweep`` / metrics), scaled out.
Every node runs the full single-node stack privately; the cluster adds
exactly three shared things:

  * the **placement table** — where every ``(model, unit, shard)``
    lives, with cluster-wide single-flight leader election, so an N-node
    scale-out burst pays at most one origin read per unit;
  * the **cluster link** — one per-channel
    :class:`~repro_torch.store.store.BandwidthModel` (channel = node
    NIC) that prices peer transfers at intra-cluster speeds, against the
    shared slow origin pipe;
  * the **front-end router** (:class:`ClusterRouter`) — places each
    request on the node already warm for the model, else the node whose
    cache holds the most of the model's units (placement-table
    locality), else the least-loaded node by the live
    ``router/in_flight`` + ``router/queue_depth`` gauges of each node's
    metrics surface.

The nodes are simulated in one process and share one device
(``device=``): a cluster on one GPU runs every node's cold starts and
decode steps on that card.
"""
from __future__ import annotations

import time
from concurrent.futures import CancelledError, Future
from typing import Any, Callable, Dict, List, Optional

from repro_torch.cluster.node import Node
from repro_torch.cluster.placement import PlacementTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.api import GenerateSpec, Request, Response
from repro_torch.serving.router import _resolve
from repro_torch.store.store import BandwidthModel, WeightStore


class ClusterRouter:
    """Locality-aware front end over one Router per node.

    ``submit`` scores every node and forwards to the winner's node-local
    Router; the returned Future resolves to the inner Response with
    ``Response.node`` stamped.  ``submit_to`` bypasses placement (for
    callers that need a deterministic target node)."""

    def __init__(self, cluster: "ClusterPlatform", *,
                 workers_per_node: int = 4,
                 max_pending: Optional[int] = None):
        self.cluster = cluster
        self._routers = {
            node.node_id: node.router(workers=workers_per_node,
                                      max_pending=max_pending)
            for node in cluster.nodes}

    # ------------------------------------------------------------- placement
    def place(self, model: str) -> Node:
        """Pick the serving node: a warm instance beats cache locality
        beats load; the node index breaks exact ties."""
        resident = self.cluster.placement.nodes_for_model(model)
        return min(
            self.cluster.nodes,
            key=lambda n: (0 if n.any_live(model) else 1,
                           -resident.get(n.node_id, 0),
                           n.load_score(),
                           n.index))

    # -------------------------------------------------------------- dispatch
    def submit(self, req: Request) -> "Future[Response]":
        return self.submit_to(self.place(req.model).node_id, req)

    def submit_to(self, node_id: str, req: Request) -> "Future[Response]":
        """Admit ``req`` on a specific node (admission errors surface
        here, on the submitting thread, as with Router.submit)."""
        inner = self._routers[node_id].submit(req)
        outer: "Future[Response]" = Future()

        def _done(f: "Future[Response]", nid=node_id):
            try:
                resp = f.result()
            except CancelledError:
                outer.cancel()
                return
            except BaseException as e:
                _resolve(outer, exc=e)
                return
            resp.node = nid
            _resolve(outer, result=resp)

        inner.add_done_callback(_done)
        return outer

    # --------------------------------------------------------------- queries
    def stats(self) -> Dict[str, Any]:
        """node id -> that node's RouterStats."""
        return {nid: r.stats for nid, r in self._routers.items()}

    def queue_depth(self) -> int:
        return sum(r.queue_depth() for r in self._routers.values())

    # -------------------------------------------------------------- shutdown
    def shutdown(self, wait: bool = True):
        for r in self._routers.values():
            r.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


class ClusterPlatform:
    """N-node serving platform: shared origin store, shared placement
    table, shared cluster link, one private serving stack per node."""

    def __init__(self, store: WeightStore,
                 builders: Dict[str, Callable[[], tuple]], *,
                 n_nodes: int = 2,
                 cluster_bw_mbps: float = 1000.0,
                 cluster_latency_ms: float = 0.1,
                 peer_exchange: bool = True,
                 cache_budget_bytes: int = 0,
                 chunk_bytes: int = 1 << 20,
                 device: DeviceLike = None,
                 **platform_kw):
        """``store``: the shared origin store — its BandwidthModel is the
        slow pipe all nodes contend on.  ``cluster_bw_mbps``: the
        intra-cluster link, one channel per node (0 -> unthrottled).
        ``peer_exchange=False``: nodes stay cluster-blind — every cold
        start reads the origin.  The per-node cache budget defaults to
        unbounded (0).  ``device``: where every node loads and serves
        (default: the GPU; raises without one unless ``device="cpu"``).
        Remaining kwargs reach every node's ServerlessPlatform."""
        self.store = store
        self.device = resolve_device(device)
        self.placement = PlacementTable()
        self.link: Optional[BandwidthModel] = None
        if cluster_bw_mbps > 0:
            self.link = BandwidthModel(bandwidth_mbps=cluster_bw_mbps,
                                       latency_ms=cluster_latency_ms,
                                       channels=max(1, int(n_nodes)))
        self._by_id: Dict[str, Node] = {}
        self.nodes: List[Node] = []
        for i in range(max(1, int(n_nodes))):
            nid = f"node{i}"
            node = Node(nid, i, store, builders,
                        placement=self.placement, link=self.link,
                        resolve_peer=self._by_id.get,
                        cache_budget_bytes=cache_budget_bytes,
                        peer_exchange=peer_exchange,
                        chunk_bytes=chunk_bytes, device=self.device,
                        **platform_kw)
            self._by_id[nid] = node
            self.nodes.append(node)
        self.last_router_stats = None   # per-node stats of the last replay

    # --------------------------------------------------------------- access
    def node(self, node_id: str) -> Node:
        return self._by_id[node_id]

    def router(self, *, workers_per_node: int = 4,
               max_pending: Optional[int] = None) -> ClusterRouter:
        """A live front-end router (the caller shuts it down)."""
        return ClusterRouter(self, workers_per_node=workers_per_node,
                             max_pending=max_pending)

    # ---------------------------------------------------------- maintenance
    def sweep(self, logical_now: float) -> int:
        """Keep-alive eviction on every node's pools; total reclaimed."""
        return sum(n.sweep(logical_now) for n in self.nodes)

    def flush(self):
        """Whole cluster back to cold: every node's instances and caches
        dropped, then any placement entries the per-node on-evict hooks
        did not already withdraw."""
        for n in self.nodes:
            n.flush()
        self.placement.clear()

    # ------------------------------------------------------------- snapshot
    _AGG_COUNTERS = ("router/submitted", "router/completed",
                     "router/cold", "router/warm",
                     "cluster/origin_reads", "cluster/origin_bytes",
                     "cluster/peer_reads", "cluster/peer_bytes",
                     "cluster/peer_served", "cluster/stale_referrals",
                     "weight_cache/hits", "weight_cache/misses")

    def cluster_snapshot(self) -> Dict[str, Any]:
        """The cluster observability surface: every node's full
        ``metrics_snapshot``, a cluster roll-up of the cross-node
        counters, the per-node load term the front-end router places by,
        and the placement table's view of where everything lives."""
        per_node: Dict[str, Any] = {}
        agg: Dict[str, float] = {}
        load: Dict[str, float] = {}
        for n in self.nodes:
            snap = n.metrics_snapshot()
            per_node[n.node_id] = snap
            counters = snap.get("counters", {})
            for name in self._AGG_COUNTERS:
                if name in counters:
                    agg[name] = agg.get(name, 0.0) + counters[name]
            g = snap.get("gauges", {})
            load[n.node_id] = (g.get("router/in_flight", {}).get("value", 0.0)
                               + g.get("router/queue_depth", {}
                                       ).get("value", 0.0))
        return {"n_nodes": len(self.nodes),
                "nodes": per_node,
                "cluster": {"counters": agg, "load": load},
                "placement": self.placement.snapshot()}

    # ----------------------------------------------------------- trace replay
    def run_trace(self, invocations, make_batch,
                  *, time_scale: float = 0.0,
                  concurrency: int = 1,
                  make_spec: Optional[Callable[[str], GenerateSpec]] = None
                  ) -> List[Response]:
        """Replay a trace through the locality-aware front end — the
        cluster twin of ``ServerlessPlatform.run_trace`` (the same
        logical keep-alive clock, serial / concurrent semantics and
        generation mode); each Response also carries the serving
        ``node``."""
        router = self.router(workers_per_node=max(1, concurrency))
        try:
            futures = []
            logical_prev = None
            clock = 0.0
            for inv in invocations:
                if logical_prev is not None:
                    gap = inv.t - logical_prev
                    clock += gap
                    if time_scale > 0:
                        # replay pacing (as the single-node engine paces)
                        time.sleep(gap * time_scale)  # analysis: ignore[R4]
                logical_prev = inv.t
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
            self.last_router_stats = router.stats()
