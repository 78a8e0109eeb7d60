"""Cluster-scale serving of the port (a port of ``repro.cluster``):
a multi-node platform with locality-aware routing and peer-to-peer
weight exchange.

The single-node stack (``repro_torch.serving`` + ``repro_torch.store``
+ ``repro_torch.core``) scales out to N simulated nodes in one process,
all on one device:

  * :class:`~repro_torch.cluster.platform.ClusterPlatform` — N
    :class:`~repro_torch.cluster.node.Node` s (each a private
    ServerlessPlatform + WeightCache + metrics registry) over one shared
    origin store;
  * :class:`~repro_torch.cluster.platform.ClusterRouter` — the
    locality-aware front end: warm node > cache-resident node >
    least-loaded node;
  * :class:`~repro_torch.cluster.placement.PlacementTable` —
    cluster-wide ``(model, unit, shard) -> holders`` map with
    origin-read leader election (cluster-wide single-flight);
  * :class:`~repro_torch.cluster.peer.ClusterShardSource` — the
    peer-exchange tier each node's cold-start retrieval streams read
    through.
"""
from repro_torch.cluster.node import Node
from repro_torch.cluster.peer import ClusterShardSource
from repro_torch.cluster.placement import ORIGIN, PEER, PlacementTable
from repro_torch.cluster.platform import ClusterPlatform, ClusterRouter

__all__ = [
    "ClusterPlatform", "ClusterRouter", "ClusterShardSource",
    "Node", "PlacementTable", "ORIGIN", "PEER",
]
