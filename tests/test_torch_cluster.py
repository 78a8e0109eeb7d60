"""The port's cluster tier (``repro_torch.cluster``) held against the JAX
package's (``repro.cluster``) on the same scripts, without a model: the
placement table's leader election, waits, aborts, drops and stale
holders give the same returns and ``snapshot()``; the peer-exchange
source over fake peers gives the same byte sources and counters, an
N-way burst one origin read per key in both packages, and a storm of
fetches and evictions keeps the table consistent; the cluster's wiring
(eviction withdraws a placement, the front end places by warmth,
locality and load, the snapshot rolls every node up) matches.

Threads are synchronised with barriers, events and the table's own
counters, never with sleeps; only counts are asserted, never wall-clock
orderings."""
import threading
import time

import pytest

from repro import cluster as jcluster
from repro import metrics as jmetrics
from repro.serving.api import Request as JRequest
from repro.store import store as jstore
from repro.store.cache import WeightCache as JCache
from repro_torch import cluster as tcluster
from repro_torch import metrics as tmetrics
from repro_torch.serving.api import Request, UnknownModelError
from repro_torch.store import store as tstore
from repro_torch.store.cache import LOAD, WeightCache

SIDES = {"port": (tcluster, tmetrics, WeightCache, tstore, Request),
         "ref": (jcluster, jmetrics, JCache, jstore, JRequest)}


def _both(fn):
    """``fn`` run on both packages; asserts the results are equal."""
    got = fn(*SIDES["port"])
    want = fn(*SIDES["ref"])
    assert got == want
    return got


def _wait_until(pred, what, timeout=30.0):
    """Poll a counter of the code under test (not a wall-clock order)."""
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# PlacementTable
# ---------------------------------------------------------------------------

def _placement_script(cl, *_):
    t = cl.PlacementTable()
    out = [t.begin_fetch("A", "m", "u")]                 # A leads
    # B, C and D wait on A's read, then are referred to A
    got = {}

    def waiter(node):
        got[node] = t.begin_fetch(node, "m", "u")

    threads = [threading.Thread(target=waiter, args=(n,)) for n in "BCD"]
    for th in threads:
        th.start()
    _wait_until(lambda: t.snapshot()["waits"] == 3, "waiters never parked")
    out.append(("parked", sorted(got)))
    t.publish("A", "m", "u")
    for th in threads:
        th.join(30)
    out.append(sorted(got.items()))
    t.publish("B", "m", "u")
    out.append(t.locate("m", "u"))
    out.append(t.begin_fetch("A", "m", "u"))             # never itself
    # an aborted leader: its waiter is re-elected
    out.append(t.begin_fetch("A", "m", "v"))
    res = []
    th = threading.Thread(target=lambda: res.append(
        t.begin_fetch("B", "m", "v")))
    th.start()
    _wait_until(lambda: t.snapshot()["waits"] == 4, "waiter never parked")
    t.abort("C", "m", "v")                               # not the leader
    t.abort("A", "m", "v")
    th.join(30)
    out.append(res)
    t.abort("A", "m", "v")                               # idempotent
    t.publish("B", "m", "v")
    t.publish("C", "n", "u", shard=1)
    out.append(t.nodes_for_model("m"))
    out.append(t.snapshot())
    # drops: the last holder gone, the next asker leads again
    t.drop("A", "m", "u")
    t.drop("B", "m", "u")
    t.drop("Z", "m", "u")                                # not a holder
    out.append(t.locate("m", "u"))
    out.append(t.begin_fetch("C", "m", "u"))
    # a stale holder (published, then evicted without a drop) is still
    # referred until the peer tier repairs it
    t.publish("D", "m", "w")
    out.append(t.begin_fetch("E", "m", "w"))
    t.clear()                                            # keeps leaders
    out.append(t.snapshot())
    return out


def test_placement_script_matches_reference():
    out = _both(_placement_script)
    assert out[0] == ("origin", None)
    assert out[2] == [(n, ("peer", "A")) for n in "BCD"]
    assert out[4] == ("peer", "B")
    assert out[6] == [("origin", None)]
    snap = out[8]
    assert snap["models"] == {"m": {"keys": 2, "copies": 3},
                              "n": {"keys": 1, "copies": 1}}
    assert (snap["origin_elections"], snap["peer_referrals"],
            snap["waits"]) == (3, 4, 4)
    assert out[10] == ("origin", None) and out[11] == ("peer", "D")
    assert out[12]["models"] == {} and out[12]["loading"] == 1


# ---------------------------------------------------------------------------
# ClusterShardSource over fake peers
# ---------------------------------------------------------------------------

class FakePeer:
    """Node.serve_shard / end_serve over a plain dict."""

    def __init__(self):
        self.payloads = {}
        self.serving = 0

    def serve_shard(self, model, unit, skey=0):
        p = self.payloads.get((model, unit, skey))
        if p is not None:
            self.serving += 1
        return p

    def end_serve(self, model, unit, skey=0):
        self.serving -= 1


COUNTERS = ("cluster/origin_reads", "cluster/origin_bytes",
            "cluster/peer_reads", "cluster/peer_bytes",
            "cluster/stale_referrals")


def _source_script(cl, mt, _cache, st, _req):
    table = cl.PlacementTable()
    peers = {f"n{i}": FakePeer() for i in range(3)}
    regs = {nid: mt.MetricsRegistry() for nid in peers}
    link = st.BandwidthModel(bandwidth_mbps=0.0, channels=3)
    src = {nid: cl.ClusterShardSource(nid, table, link, peers.get,
                                      channel=i, chunk_bytes=100,
                                      metrics=regs[nid])
           for i, nid in enumerate(peers)}
    out, chunks = [], []

    def fetch(nid, unit, nbytes, origin="o"):
        payload, where = src[nid].fetch("m", unit, 0, nbytes,
                                        lambda: {"w": origin},
                                        on_chunk=chunks.append)
        if where == "origin":
            peers[nid].payloads[("m", unit, 0)] = payload
        src[nid].publish("m", unit, 0)
        out.append((nid, unit, where, payload))

    fetch("n0", "u", 250)                  # leader: origin
    fetch("n1", "u", 250)                  # peer n0, three link chunks
    fetch("n2", "u", 250)                  # peer n0 (landing order)
    table.publish("n2", "m", "v")          # a stale holder: holds nothing
    fetch("n1", "v", 40)                   # stale: repaired, origin
    table.publish("ghost", "m", "x")       # an unknown node id
    fetch("n0", "x", 10)                   # stale too: origin
    src["n2"].abort("m", "y", 0)           # abort without leading: no-op
    return (out, chunks, table.snapshot(), table.locate("m", "v"),
            [p.serving for p in peers.values()],
            {nid: {c: r.counter(c).value for c in COUNTERS}
             for nid, r in regs.items()})


def test_source_over_fake_peers_matches_reference():
    out, chunks, snap, v_holders, serving, counters = _both(_source_script)
    assert [w for *_, w, _p in out] == ["origin", "peer", "peer", "origin",
                                         "origin"]
    assert chunks == [100, 100, 50] * 2    # the two peer transfers
    assert v_holders == ["n1"] and serving == [0, 0, 0]
    assert counters["n1"]["cluster/stale_referrals"] == 1
    assert counters["n0"]["cluster/stale_referrals"] == 1
    assert counters["n1"]["cluster/peer_bytes"] == 250
    assert counters["n0"]["cluster/origin_reads"] == 2


@pytest.mark.parametrize("n", [2, 4, 6])
def test_nway_burst_one_origin_read_per_key_in_both(n):
    """N nodes fetch the same keys at once through a barrier: exactly one
    origin read a key, everyone else is served by a peer, every pin is
    released, and every node is a holder — in both packages."""
    def burst(cl, *_):
        table = cl.PlacementTable()
        peers = {f"n{i}": FakePeer() for i in range(n)}
        sources = {nid: cl.ClusterShardSource(nid, table, None, peers.get)
                   for nid in peers}
        reads, lock = [], threading.Lock()
        srcs = {}
        barrier = threading.Barrier(n)

        def fetch(nid):
            barrier.wait()
            for unit in ("u0", "u1", "u2"):
                def read_origin(u=unit):
                    with lock:
                        reads.append(u)
                    return {"w": u}
                payload, where = sources[nid].fetch("m", unit, 0, 8,
                                                    read_origin)
                if where == "origin":
                    peers[nid].payloads[("m", unit, 0)] = payload
                sources[nid].publish("m", unit, 0)
                srcs[(nid, unit)] = where

        threads = [threading.Thread(target=fetch, args=(nid,))
                   for nid in peers]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        return (sorted(reads), sorted(srcs.values()),
                [p.serving for p in peers.values()],
                [len(table.locate("m", u)) for u in ("u0", "u1", "u2")],
                table.snapshot()["origin_elections"])

    reads, srcs, serving, holders, elections = _both(burst)
    assert reads == ["u0", "u1", "u2"] and elections == 3
    assert srcs == ["origin"] * 3 + ["peer"] * (3 * (n - 1))
    assert serving == [0] * n and holders == [n] * 3


@pytest.mark.parametrize("side", ["port", "ref"])
def test_storm_keeps_the_table_consistent(side):
    """Three nodes fetch, publish and evict four keys for six rounds: no
    error, no hang, and every recorded holder really holds its key."""
    cl, _, cache_cls, _, _ = SIDES[side]
    table = cl.PlacementTable()

    class StormNode:
        def __init__(self, nid):
            self.node_id = nid
            self.cache = cache_cls(on_evict=self._on_evict)

        def _on_evict(self, key):
            table.drop(self.node_id, *key)

        def serve_shard(self, model, unit, skey=0):
            return self.cache.try_get(model, unit, skey)

        def end_serve(self, model, unit, skey=0):
            self.cache.release(model, unit, skey)

    nodes = {f"n{i}": StormNode(f"n{i}") for i in range(3)}
    sources = {nid: cl.ClusterShardSource(nid, table, None, nodes.get)
               for nid in nodes}
    errors = []

    def worker(nid):
        node, source = nodes[nid], sources[nid]
        try:
            for _ in range(6):
                for k in range(4):
                    unit = f"u{k}"
                    status, _ = node.cache.begin("m", unit)
                    if status != LOAD:
                        node.cache.release("m", unit)
                        continue
                    try:
                        payload, _ = source.fetch("m", unit, 0, 64,
                                                  lambda u=unit: {"w": u})
                        node.cache.complete("m", unit, payload, 64)
                        source.publish("m", unit, 0)
                    except BaseException:
                        node.cache.abort("m", unit)
                        source.abort("m", unit, 0)
                        raise
                    node.cache.release("m", unit)
                node.cache.clear()          # eviction pressure
        except BaseException as e:
            errors.append((nid, e))

    threads = [threading.Thread(target=worker, args=(nid,))
               for nid in nodes]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    assert not errors and not any(th.is_alive() for th in threads)
    for k in range(4):
        for h in table.locate("m", f"u{k}"):
            assert nodes[h].cache.try_get("m", f"u{k}") is not None
            nodes[h].cache.release("m", f"u{k}")


# ---------------------------------------------------------------------------
# ClusterPlatform wiring, no model (empty builders)
# ---------------------------------------------------------------------------

def _empty(cl, st, tmp_path, n=2, **kw):
    if cl is tcluster:
        kw["device"] = "cpu"
    return cl.ClusterPlatform(st.WeightStore(str(tmp_path)), {}, n_nodes=n,
                              cluster_bw_mbps=0.0, **kw)


def test_router_places_by_warmth_locality_and_load(tmp_path):
    def script(cl, _mt, _c, st, _req):
        cp = _empty(cl, st, tmp_path / str(id(cl)), n=3)
        router = cp.router()
        try:
            out = [router.place("m").node_id]                # tie -> index
            cp.node("node0").metrics.gauge("router/in_flight").add(5)
            cp.node("node1").metrics.gauge("router/in_flight").add(2)
            out.append(router.place("m").node_id)            # least loaded
            cp.placement.publish("node1", "m", "u0")
            cp.placement.publish("node1", "m", "u1")
            cp.placement.publish("node2", "m", "u0")
            out.append(router.place("m").node_id)            # most resident
            cp.node("node1").metrics.gauge("router/queue_depth").add(50)
            out.append(router.place("m").node_id)            # load < locality
            out.append(router.place("other").node_id)
            out.append(router.queue_depth())
        finally:
            router.shutdown()
        return out

    assert _both(script) == ["node0", "node2", "node1", "node1", "node2", 0]


def test_submit_unknown_model_raises_on_submitting_thread(tmp_path):
    cp = _empty(tcluster, tstore, tmp_path)
    router = cp.router()
    try:
        with pytest.raises(UnknownModelError):
            router.submit(Request(req_id=0, model="nope", batch={}))
        with pytest.raises(UnknownModelError):
            router.submit_to("node1", Request(req_id=1, model="nope"))
    finally:
        router.shutdown()
    assert set(router.stats()) == {"node0", "node1"}


def test_node_eviction_withdraws_placement_entry(tmp_path):
    def script(cl, _mt, _c, st, _req):
        cp = _empty(cl, st, tmp_path / str(id(cl)), cache_budget_bytes=150)
        node = cp.node("node0")
        status, _ = node.cache.begin("m", "u0")
        node.cache.complete("m", "u0", {"w": 0}, 100)
        node.source.publish("m", "u0", 0)
        node.cache.release("m", "u0")
        out = [status, cp.placement.locate("m", "u0")]
        node.cache.begin("m", "u1")              # 200 > 150: u0 evicted
        node.cache.complete("m", "u1", {"w": 1}, 100)
        node.source.publish("m", "u1", 0)
        node.cache.release("m", "u1")
        out.append(cp.placement.locate("m", "u0"))
        out.append(cp.placement.begin_fetch("node1", "m", "u0"))
        out.append(node.serve_shard("m", "u1"))
        node.end_serve("m", "u1")
        out.append(node.serve_shard("m", "u0"))  # gone: a stale referral
        out.append(node.metrics.counter("cluster/peer_served").value)
        cp.flush()
        out.append(cp.placement.snapshot()["models"])
        return out

    out = _both(script)
    assert out[1] == ["node0"] and out[2] == [] and out[3] == ("origin", None)
    assert out[4] == {"w": 1} and out[5] is None and out[6] == 1
    assert out[7] == {}


def test_cluster_snapshot_matches_reference(tmp_path):
    def script(cl, _mt, _c, st, _req):
        cp = _empty(cl, st, tmp_path / str(id(cl)))
        cp.node("node0").metrics.counter("cluster/origin_reads").inc(3)
        cp.node("node1").metrics.counter("cluster/peer_reads").inc(2)
        cp.node("node1").metrics.gauge("router/queue_depth").set(4)
        cp.placement.publish("node0", "m", "u0")
        snap = cp.cluster_snapshot()
        return (snap["n_nodes"], sorted(snap["nodes"]), snap["cluster"],
                snap["placement"],
                sorted(snap["nodes"]["node0"]["counters"]),
                cp.link is None, [n.source.channel for n in cp.nodes])

    n, nodes, agg, placement, counters, no_link, channels = _both(script)
    assert (n, nodes, channels, no_link) == (2, ["node0", "node1"], [0, 1],
                                             True)
    assert agg["counters"]["cluster/origin_reads"] == 3.0
    assert agg["counters"]["cluster/peer_reads"] == 2.0
    assert agg["load"] == {"node0": 0.0, "node1": 4.0}
    assert placement["models"] == {"m": {"keys": 1, "copies": 1}}
    assert "cluster/origin_reads" in counters


def test_link_has_one_channel_a_node_and_peer_exchange_can_be_off(tmp_path):
    def script(cl, _mt, _c, st, _req):
        cp = _empty(cl, st, tmp_path / str(id(cl)), n=3)
        cp2 = cl.ClusterPlatform(
            st.WeightStore(str(tmp_path / str(id(cl)))), {}, n_nodes=3,
            cluster_bw_mbps=500.0, peer_exchange=False,
            **({"device": "cpu"} if cl is tcluster else {}))
        return (cp.link, len(cp2.link._next_free), cp2.link.bandwidth_mbps,
                cp2.link.latency_ms, [n.source for n in cp2.nodes],
                [n.platform.source for n in cp2.nodes],
                [n.cache is n.platform.cache for n in cp2.nodes])

    link, channels, bw, lat, sources, psources, shared = _both(script)
    assert link is None and channels == 3 and (bw, lat) == (500.0, 0.1)
    assert sources == psources == [None] * 3 and shared == [True] * 3
