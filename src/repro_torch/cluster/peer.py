"""Peer-to-peer weight exchange: the cluster's second store tier.

A :class:`ClusterShardSource` is one node's view of the tier.  It plugs
into the :class:`~repro_torch.core.decoupler.WeightDecoupler` as its
``ShardSource``: whenever a retrieval stream misses the node-local
WeightCache, the source asks the cluster-wide
:class:`~repro_torch.cluster.placement.PlacementTable` where the key
lives —

  * **nowhere yet** → this node is elected the cluster-wide leader and
    the stream runs the decoupler's ordinary origin-store read (the one
    origin read the whole burst pays for this key);
  * **on a peer** → the payload is taken straight out of the peer node's
    cache (:meth:`~repro_torch.cluster.node.Node.serve_shard`, a pinned
    non-blocking peek) and the transfer is charged to the intra-cluster
    link — the same per-channel
    :class:`~repro_torch.store.store.BandwidthModel` as the origin
    store, with link numbers (GB/s instead of a shared origin pipe),
    chunked and suspendable under the same Algorithm-1 gate as any other
    stream.

Payloads cross nodes by reference — the simulation's stand-in for an
RDMA transfer: the leaves are host tensors (pinned on a GPU host) that
both caches account as resident, as a real cluster would hold them.
Every consumer treats them as immutable: weight application copies them
to the device and never writes into a cached leaf.  The
``serve_shard`` / ``end_serve`` pin covers only the simulated wire; the
asker's own cache reference keeps the tensors alive after that.

**Stale referrals** (the peer evicted between publish and our fetch —
its on-evict drop raced the table read): ``serve_shard`` returns None,
the source drops the dead holder from the table and retries
``begin_fetch``, which eventually degrades to an ORIGIN read.  The
origin store is always the correctness backstop; peers are purely a fast
path.
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, Optional, Tuple

from repro_torch import metrics as metrics_mod
from repro_torch.cluster.placement import ORIGIN, PlacementTable
from repro_torch.core.decoupler import ShardSource
from repro_torch.store.store import BandwidthModel


class ClusterShardSource(ShardSource):
    """One node's byte source for cache-missing retrieval streams:
    placement-table lookup, peer transfer over the cluster link, origin
    fallback — with cluster-wide single-flight leader election."""

    def __init__(self, node_id: str, placement: PlacementTable,
                 link: Optional[BandwidthModel],
                 resolve_peer: Callable[[str], Optional[Any]], *,
                 channel: int = 0, chunk_bytes: int = 1 << 20,
                 metrics: Optional[metrics_mod.MetricsRegistry] = None):
        """``link``: the shared intra-cluster BandwidthModel (None ->
        unthrottled, e.g. unit tests); ``channel``: this node's NIC —
        every node charges its own channel, so peer transfers to
        different nodes run in parallel.  ``resolve_peer``: node id ->
        Node (None when unknown)."""
        self.node_id = node_id
        self.placement = placement
        self.link = link
        self.resolve_peer = resolve_peer
        self.channel = int(channel)
        self.chunk_bytes = int(chunk_bytes)
        m = metrics_mod.resolve(metrics)
        self._m_origin = m.counter("cluster/origin_reads")
        self._m_origin_bytes = m.counter("cluster/origin_bytes")
        self._m_peer = m.counter("cluster/peer_reads")
        self._m_peer_bytes = m.counter("cluster/peer_bytes")
        self._m_stale = m.counter("cluster/stale_referrals")

    # ------------------------------------------------------------ ShardSource
    def fetch(self, model: str, unit: str, skey: Hashable, nbytes: int,
              read_origin: Callable[[], Any], *,
              gate=None, on_chunk=None) -> Tuple[Any, str]:
        while True:
            mode, peer_id = self.placement.begin_fetch(
                self.node_id, model, unit, skey)
            if mode == ORIGIN:
                # leadership is released by publish() / abort(), both
                # driven by the decoupler after the local cache settles
                payload = read_origin()
                self._m_origin.inc()
                self._m_origin_bytes.inc(max(0, int(nbytes)))
                return payload, "origin"
            payload = self._fetch_from_peer(peer_id, model, unit, skey,
                                            nbytes, gate, on_chunk)
            if payload is not None:
                self._m_peer.inc()
                self._m_peer_bytes.inc(max(0, int(nbytes)))
                return payload, "peer"
            # stale referral: repair the table and re-resolve (another
            # holder, a new leader's publish, or our own election)
            self._m_stale.inc()
            self.placement.drop(peer_id, model, unit, skey)

    def publish(self, model: str, unit: str, skey: Hashable):
        self.placement.publish(self.node_id, model, unit, skey)

    def abort(self, model: str, unit: str, skey: Hashable):
        self.placement.abort(self.node_id, model, unit, skey)

    # ------------------------------------------------------------- internals
    def _fetch_from_peer(self, peer_id: str, model: str, unit: str,
                         skey: Hashable, nbytes: int, gate, on_chunk
                         ) -> Optional[Any]:
        """One peer transfer: pin the entry in the peer's cache, charge
        the wire cost to this node's link channel, unpin.  Returns None
        when the peer no longer holds the key."""
        peer = self.resolve_peer(peer_id)
        if peer is None:
            return None
        payload = peer.serve_shard(model, unit, skey)
        if payload is None:
            return None
        try:
            if self.link is not None:
                self.link.transfer(nbytes, channel=self.channel,
                                   chunk_bytes=self.chunk_bytes,
                                   gate=gate, on_chunk=on_chunk)
            elif on_chunk is not None:
                on_chunk(max(0, int(nbytes)))
        finally:
            # the pin held the entry against eviction for the whole
            # modeled transfer — an eviction can only come *before*
            # serve_shard pins (the stale-referral path above)
            peer.end_serve(model, unit, skey)
        return payload
