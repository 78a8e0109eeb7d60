"""The port's cluster serving real cold starts on the CPU, held against the
JAX package's cluster on one store the JAX package deployed (smollm-360m
smoke, f32 compute; the JAX side under ``REPRO_PALLAS=ref``): a second
node's cold start is served by its peer with zero origin reads and both
nodes' logits agree with JAX's within 1e-4; a four-node cold burst pays
one origin read per key cluster-wide in both packages (and four per key
with peer exchange off); ``run_trace`` through the front end gives the
same cold flags, node assignment and tokens; the warm node takes the
routed requests; and the peer payloads are shared, never written.

Only counts are asserted, never wall-clock orderings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import cluster as jcluster
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import pool as jpool
from repro.serving import trace as jtrace
from repro.serving.api import GenerateSpec as JSpec
from repro.serving.api import Request as JRequest
from repro.store import store as jstore
from repro_torch import cluster as tcluster
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving import GenerateSpec, Request
from repro_torch.serving import pool as tpool
from repro_torch.serving import trace as ttrace
from repro_torch.store import store as tstore
from torch_testlib import COLDSTART_TOL

torch.set_num_threads(2)

MODEL = "smollm-360m"


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    jcfg = dataclasses.replace(jget_config(MODEL, smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(MODEL, smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jstore.deploy_model(jstore.WeightStore(root), jm, MODEL,
                        jax.random.key(7))
    tm = transformer.build(tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (1, 8))
    n_keys = len(tm.unit_names())
    return root, jm, tm, tokens, n_keys


class Recorded:
    """Every invoke's logits (cold loads and warm forwards), in call
    order, on either package."""

    def __init__(self, pool_mod, mp, to_np):
        self.logits = []
        orig = pool_mod.FunctionInstance.invoke

        def invoke(inst, batch):
            out, info = orig(inst, batch)
            self.logits.append(to_np(out))
            return out, info
        mp.setattr(pool_mod.FunctionInstance, "invoke", invoke)


def _port(deployed, mp, n=2, **kw):
    root, _, tm, tokens, _ = deployed
    rec = Recorded(tpool, mp, lambda o: o.float().numpy())
    batch = {"tokens": torch.as_tensor(tokens)}
    kw.setdefault("keep_alive_s", 1e9)
    cp = tcluster.ClusterPlatform(
        tstore.WeightStore(root), {MODEL: lambda: (tm, batch)}, n_nodes=n,
        cluster_bw_mbps=2000.0, device="cpu", **kw)
    return cp, batch, rec, Request


def _ref(deployed, mp, n=2, **kw):
    root, jm, _, tokens, _ = deployed
    mp.setenv("REPRO_PALLAS", "ref")
    rec = Recorded(jpool, mp, lambda o: np.asarray(o, np.float32))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    kw.setdefault("keep_alive_s", 1e9)
    cp = jcluster.ClusterPlatform(
        jstore.WeightStore(root), {MODEL: lambda: (jm, batch)}, n_nodes=n,
        cluster_bw_mbps=2000.0, **kw)
    return cp, batch, rec, JRequest


def _pinned_pair(make, deployed):
    """node0 cold-starts, then node1: counts, sources and logits."""
    with pytest.MonkeyPatch.context() as mp:
        cp, batch, rec, req = make(deployed, mp)
        router = cp.router(workers_per_node=2)
        try:
            r0 = router.submit_to("node0", req(0, MODEL, batch)).result(120)
            r1 = router.submit_to("node1", req(1, MODEL, batch)).result(120)
        finally:
            router.shutdown()
    n0, n1 = cp.nodes
    last = [next(iter(nd.platform.pools[MODEL]._instances)).last_load
            for nd in cp.nodes]
    srcs = [sorted({tuple(sorted((e.meta or {}).keys()))
                    for e in ld.trace.events_for("R").values()})
            for ld in last]
    pl = cp.placement.snapshot()["models"][MODEL]
    return cp, dict(
        flags=[(r.req_id, r.cold, r.node) for r in (r0, r1)],
        reads=[(n0.origin_reads(), n0.peer_reads()),
               (n1.origin_reads(), n1.peer_reads())],
        served=[nd.metrics.counter("cluster/peer_served").value
                for nd in cp.nodes],
        placement=pl, srcs=srcs), rec.logits


def test_second_node_cold_start_is_peer_served(deployed):
    n_keys = deployed[4]
    tcp, got, tlog = _pinned_pair(_port, deployed)
    _, want, jlog = _pinned_pair(_ref, deployed)
    assert got == want
    assert got["flags"] == [(0, True, "node0"), (1, True, "node1")]
    assert got["reads"] == [(n_keys, 0), (0, n_keys)]
    assert got["served"] == [n_keys, 0]
    assert got["placement"] == {"keys": n_keys, "copies": 2 * n_keys}
    assert got["srcs"] == [[()], [("peer",)]]
    assert len(tlog) == len(jlog) == 2
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a, b, **COLDSTART_TOL)
    np.testing.assert_array_equal(tlog[0], tlog[1])
    # the payloads crossed by reference and nothing wrote into them: both
    # caches hold the same host tensors, equal to the store's bytes
    c0, c1 = (nd.cache for nd in tcp.nodes)
    store = tstore.WeightStore(deployed[0])
    for unit in tcp.nodes[0].platform.pools[MODEL]._instances[0] \
            .model.unit_names():
        a, b = c0.try_get(MODEL, unit), c1.try_get(MODEL, unit)
        fresh = store.read_and_deserialize(MODEL, unit)
        assert a is b
        for name, (arr, scale) in a.items():
            assert scale is None and torch.equal(arr, fresh[name][0])
        c0.release(MODEL, unit)
        c1.release(MODEL, unit)


def _burst(make, deployed, peer_exchange):
    with pytest.MonkeyPatch.context() as mp:
        cp, batch, rec, req = make(deployed, mp, n=4,
                                   peer_exchange=peer_exchange)
        router = cp.router(workers_per_node=2)
        try:
            futs = [router.submit_to(nd.node_id, req(i, MODEL, batch))
                    for i, nd in enumerate(cp.nodes)]
            rs = [f.result(180) for f in futs]
        finally:
            router.shutdown()
    snap = cp.cluster_snapshot()
    agg = snap["cluster"]["counters"]
    pl = snap["placement"]
    cache_misses = [nd.cache.stats().misses for nd in cp.nodes]
    cp.flush()
    return dict(
        cold=[r.cold for r in rs], nodes=[r.node for r in rs],
        origin=agg.get("cluster/origin_reads", 0.0),
        peer=agg.get("cluster/peer_reads", 0.0),
        models=pl["models"], elections=pl["origin_elections"],
        misses=cache_misses,
        flushed=cp.placement.snapshot()["models"]), rec.logits


@pytest.mark.parametrize("peer_exchange", [True, False],
                         ids=["peer", "origin-only"])
def test_four_node_burst_origin_reads(deployed, peer_exchange):
    n_keys = deployed[4]
    got, tlog = _burst(_port, deployed, peer_exchange)
    want, jlog = _burst(_ref, deployed, peer_exchange)
    assert got == want
    assert got["cold"] == [True] * 4
    assert got["nodes"] == [f"node{i}" for i in range(4)]
    assert got["misses"] == [n_keys] * 4 and got["flushed"] == {}
    if peer_exchange:
        # one origin read a key, cluster-wide; the rest from peers
        assert (got["origin"], got["peer"]) == (n_keys, 3 * n_keys)
        assert got["models"] == {MODEL: {"keys": n_keys,
                                         "copies": 4 * n_keys}}
        assert got["elections"] == n_keys
    else:
        assert (got["origin"], got["peer"]) == (0.0, 0.0)
        assert got["models"] == {} and got["elections"] == 0
    for a in tlog:
        np.testing.assert_allclose(a, jlog[0], **COLDSTART_TOL)
        np.testing.assert_array_equal(a, tlog[0])


def _replay(make, trace_mod, spec_cls, deployed):
    vocab = deployed[2].cfg.vocab_size
    trace = trace_mod.azure_like_trace(duration_s=240.0, n_invocations=8,
                                       models=(MODEL,), seed=2)
    rng = np.random.default_rng(5)
    with pytest.MonkeyPatch.context() as mp:
        cp, _, rec, _ = make(deployed, mp, keep_alive_s=20.0)
        out = cp.run_trace(trace, None, make_spec=lambda name: spec_cls(
            prompt=rng.integers(0, vocab, (6,)).astype(np.int32), n_new=4))
    agg = cp.cluster_snapshot()["cluster"]["counters"]
    return dict(ids=[r.req_id for r in out], cold=[r.cold for r in out],
                nodes=[r.node for r in out],
                tokens=[list(map(int, r.tokens)) for r in out],
                completed=agg["router/completed"],
                origin=agg.get("cluster/origin_reads", 0.0),
                stats={nid: (s.submitted, s.completed)
                       for nid, s in cp.last_router_stats.items()})


def test_run_trace_through_the_front_end_matches_reference(deployed):
    got = _replay(_port, ttrace, GenerateSpec, deployed)
    want = _replay(_ref, jtrace, JSpec, deployed)
    assert got == want
    cold = got["cold"]
    assert cold[0] and True in cold[1:] and False in cold
    assert all(n in ("node0", "node1") for n in got["nodes"])
    assert got["completed"] == 8 and all(len(t) == 4 for t in got["tokens"])
    # the re-cold-starts read nothing: node0's cache holds every unit
    assert got["origin"] == deployed[4]


def test_routed_requests_follow_the_warm_node(deployed):
    with pytest.MonkeyPatch.context() as mp:
        cp, batch, rec, req = _port(deployed, mp)
        router = cp.router(workers_per_node=2)
        try:
            r0 = router.submit_to("node1", req(0, MODEL, batch)).result(120)
            rs = [router.submit(req(i, MODEL, batch)).result(60)
                  for i in range(1, 4)]
        finally:
            router.shutdown()
    assert r0.cold and r0.node == "node1"
    assert all(r.node == "node1" and not r.cold for r in rs)
    for a in rec.logits[1:]:
        np.testing.assert_allclose(a, rec.logits[0], **COLDSTART_TOL)
    assert cp.node("node0").origin_reads() == 0
    assert cp.nodes[0].platform.pool_stats()[MODEL].size == 0
