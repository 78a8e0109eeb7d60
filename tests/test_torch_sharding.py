"""The port's sharding rules, logical mesh and shard plans against the
JAX package's.

The reference plans on a mesh of four simulated host devices, which a
process must ask for before it imports JAX, so its plans come from one
module-scoped subprocess (``tests/torch_shard_oracle.py``) over stores
the JAX package deployed; the port plans over the same stores, on a
logical mesh on the CPU, and every spec, index map, plan, tag and byte
run must be equal, exactly: (1, 2), (1, 4) and (2, 2) meshes, f32 and
int8 stores, ``apply_dtype`` None and bfloat16, smollm-360m (3 heads
replicate on 4 devices), mixtral-8x7b (the expert axis) and
recurrentgemma-2b at smoke size, plus the reference's wide int8 and
all-indivisible configs; and the training half's cache and batch specs.  Last, a two-node cluster whose nodes serve
shard-granular cold starts.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_shard_oracle as oracle
from repro.store.store import WeightStore as JStore
from repro_torch.cluster import ClusterPlatform
from repro_torch.core.shards import plan_tag, plan_unit
from repro_torch.distributed.sharding import (NamedSharding, P,
                                              batch_specs, cache_specs,
                                              leaf_specs, param_specs,
                                              replicated, serve_rules,
                                              train_rules)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.store.store import (WeightStore, deploy_model,
                                     leaf_path_name, slice_byte_runs)
from repro_torch import tree as tree_util
from torch_testlib import ROOT

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's plans (and the store directory they read)."""
    d = tmp_path_factory.mktemp("shard-oracle")
    out = d / "plans.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_PALLAS="ref",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tests" /
                                        "torch_shard_oracle.py"),
                    str(d / "store"), str(out)], env=env, check=True,
                   timeout=300)
    with open(out) as f:
        got = json.load(f)
    got["store"] = WeightStore(str(d / "store"))
    return got


def _model(case):
    arch, over, _ = oracle.CASES[case]
    return transformer.build(dataclasses.replace(
        get_config(arch, smoke=True), **over), device="cpu")


def _meshes():
    return {"x".join(map(str, s)): make_serving_mesh(s, device="cpu")
            for s in oracle.MESHES}


def _port_plans(ref, cases, adts=oracle.APPLY):
    out = {}
    for case in cases:
        model = _model(case)
        for mk, mesh in _meshes().items():
            for adt in adts:
                for u in model.unit_names():
                    plan = plan_unit(ref["store"], case, u,
                                     model.abstract_unit(u), mesh,
                                     serve_rules(),
                                     apply_dtype=getattr(torch, adt)
                                     if adt else None)
                    out[f"{case}/{mk}/{adt}/{u}"] = oracle.enc_plan(
                        plan, slice_byte_runs)
    return out


def _ref_plans(ref, cases, adts=oracle.APPLY):
    return {k: v for k, v in ref["plans"].items()
            if k.split("/")[0] in cases and
            k.split("/")[2] in {str(a) for a in adts}}


@pytest.mark.parametrize("case", ["smollm", "mixtral", "rgemma"])
def test_leaf_specs_and_index_maps_match_reference(ref, case):
    """Every unit's leaf specs and every leaf's index map, at each mesh."""
    got = _port_plans(ref, [case], adts=(None,))
    want = _ref_plans(ref, [case], adts=(None,))
    assert set(got) == set(want) and got
    sharded = 0
    for key in want:
        assert got[key]["specs"] == want[key]["specs"], key
        assert got[key]["imaps"] == want[key]["imaps"], key
        sharded += sum(any(a is not None for a in s)
                       for s in got[key]["specs"].values())
    assert sharded > 0                      # the rules shard something


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("adt", oracle.APPLY)
def test_plans_match_reference(ref, store, adt):
    """plan_unit piece for piece (owner stream, slice, bytes, devices),
    with commit, transformed, out_dtype, the tag and each ranged piece's
    byte runs, for the three families at every mesh."""
    cases = [c + ("-q" if store == "int8" else "")
             for c in ("smollm", "mixtral", "rgemma")]
    got = _port_plans(ref, cases, adts=(adt,))
    want = _ref_plans(ref, cases, adts=(adt,))
    assert set(got) == set(want) and got
    for key in want:
        assert got[key] == want[key], key
    # the int8 stores transform their int8 leaves; the cast, float ones
    assert any(any(p["transformed"].values()) for p in got.values()) == \
        (store == "int8" or adt is not None)


def test_wide_int8_and_indivisible_plans_match_reference(ref):
    """The reference's wide int8 config (ranged int8 pieces with their
    scale slices) and its all-indivisible one (every leaf replicates)."""
    got = _port_plans(ref, ["wide-q", "odd"])
    want = _ref_plans(ref, ["wide-q", "odd"])
    assert set(got) == set(want) and got
    for key in want:
        assert got[key] == want[key], key
    ranged_q = [p for k, v in got.items() if k.startswith("wide-q/1x4")
                for shard in v["pieces"] for p in shard
                if p[1] is not None and v["transformed"][p[0]]]
    assert ranged_q
    assert all(all(all(a is None for a in s) for s in v["specs"].values())
               for k, v in got.items() if k.startswith("odd/1x4"))


def test_stacked_param_specs_match_reference(ref):
    """param_specs of the whole stacked tree (the specs a load reports
    in ``LoadResult.shardings``)."""
    for case in ("smollm", "mixtral", "rgemma"):
        model = _model(case)
        for mk, mesh in _meshes().items():
            specs = param_specs(model.abstract(), mesh, serve_rules())
            got = {leaf_path_name(p): oracle.enc_spec(s.spec)
                   for p, s in tree_util.leaves_with_path(specs)}
            assert got == ref["stacked"][f"{case}/{mk}"], (case, mk)


def test_cache_and_batch_specs_match_reference(ref):
    """The training half: ``cache_specs`` of each case's decode cache and
    ``batch_specs`` of a batch with divisible, half-divisible and odd
    leading dims, under both rule sets, on every mesh."""
    rules = {"serve": serve_rules(), "train": train_rules()}
    for case in ("smollm", "mixtral", "rgemma"):
        cache = _model(case).init_cache(*oracle.CACHE_SHAPE)
        for mk, mesh in _meshes().items():
            for rn, rl in rules.items():
                got = oracle.enc_tree(cache_specs(cache, mesh, rl))
                assert got == ref["cache"][f"{case}/{mk}/{rn}"], (case, mk)
    batch = {k: torch.empty(v, dtype=torch.int32, device="meta")
             for k, v in oracle.BATCHES.items()}
    for mk, mesh in _meshes().items():
        for rn, rl in rules.items():
            assert oracle.enc_tree(batch_specs(batch, mesh, rl)) == \
                ref["batch"][f"{mk}/{rn}"], (mk, rn)
    assert ref["batch"]["2x2/train"]["tokens"] == ["data"]
    assert ref["batch"]["1x4/train"]["tokens"] == []


def test_plan_tags_match_reference(ref):
    got = {mk: {"serve": plan_tag(m, serve_rules()),
                "train": plan_tag(m, train_rules())}
           for mk, m in _meshes().items()}
    assert got == ref["tags"]
    assert got["1x4"]["serve"].startswith("1x4#")
    assert len({t for v in got.values() for t in v.values()}) == 6


def test_slice_byte_runs_match_reference(ref):
    got = [[list(r) for r in slice_byte_runs(tuple(shape), item,
                                             oracle.as_index(index))]
           for shape, item, index in oracle.run_cases()]
    assert got == ref["runs"]
    assert any(len(r) > 1 for r in got)        # strided slices among them


def test_read_leaf_slice_matches_reference(ref):
    """Every piece of every (1, 4) plan read by the port's
    ``read_leaf_slice`` — gathered into a contiguous tensor or into a
    strided ``out`` view — holds the bytes (and, int8,
    the scales) the JAX store's ``read_leaf_slice`` returns; every read
    charges ``leaf_slice_nbytes`` to its stream's callback."""
    jstore = JStore(ref["store"].root)
    m4 = make_serving_mesh((1, 4), device="cpu")
    for case in ("smollm", "smollm-q", "mixtral-q", "wide-q"):
        model = _model(case)
        for u in model.unit_names():
            plan = plan_unit(ref["store"], case, u, model.abstract_unit(u),
                             m4, serve_rules())
            for shard, pieces in enumerate(plan.pieces):
                with ref["store"].open_unit(case, u) as fh:
                    for p in pieces:
                        want, wscale = jstore.read_leaf_slice(
                            case, u, p.leaf, p.index, channel=shard)
                        assert p.nbytes == jstore.leaf_slice_nbytes(
                            case, u, p.leaf, p.index)
                        charged = []
                        got, scale = ref["store"].read_leaf_slice(
                            case, u, p.leaf, p.index, fh=fh, channel=shard,
                            on_chunk=charged.append)
                        assert sum(charged) == p.nbytes
                        assert got.numpy().tobytes() == \
                            np.ascontiguousarray(want).tobytes()
                        assert (scale is None) == (wscale is None)
                        if scale is not None:
                            assert np.array_equal(scale.numpy(), wscale)
                        if p.index is None:
                            continue
                        full = torch.zeros(plan.shapes[p.leaf],
                                           dtype=got.dtype)
                        dest = full[p.index]
                        viewed, _ = ref["store"].read_leaf_slice(
                            case, u, p.leaf, p.index, fh=fh, out=dest)
                        assert viewed is dest and torch.equal(dest, got)


def test_logical_mesh():
    """(4,) is (1, 4); other ranks raise; devices are logical, keyed by
    id, on the one physical device; index maps as JAX's, with the
    multi-axis dim row-major over (data, model)."""
    m = make_serving_mesh((4,), device="cpu")
    assert m.shape == {"data": 1, "model": 4} and m.size == 4
    assert [d.id for d in m.devices.flat] == [0, 1, 2, 3]
    assert {d.device for d in m.devices.flat} == {torch.device("cpu")}
    assert len(set(m.devices.flat)) == 4       # ids keep them apart
    for bad in ((1, 2, 2), ()):
        with pytest.raises(ValueError, match="1- or 2-d"):
            make_serving_mesh(bad, device="cpu")
    m2 = make_serving_mesh((2, 2), device="cpu")
    imap = NamedSharding(m2, P(("data", "model"))).devices_indices_map(
        (8, 6))
    assert [idx[0] for idx in imap.values()] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert all(idx[1] == slice(None) for idx in imap.values())
    imap = NamedSharding(m2, P(None, "model")).devices_indices_map((8, 6))
    assert [idx[1] for idx in imap.values()] == [
        slice(0, 3), slice(3, 6), slice(0, 3), slice(3, 6)]
    assert replicated(m2).is_fully_replicated and replicated(m2).spec == ()
    assert not NamedSharding(m2, P("model")).is_fully_replicated
    assert NamedSharding(make_serving_mesh((2, 1), device="cpu"),
                         P(None, "model")).is_fully_replicated
    # smollm's 3 heads do not divide 4: the attention projections
    # replicate while the FFN and the vocabulary shard
    specs = leaf_specs(_model("smollm").abstract_unit("block_000"), m,
                       serve_rules())
    assert tuple(specs["attn/wq"].spec) == ()
    assert tuple(specs["mlp/wg"].spec) == (None, "model")


def test_cluster_nodes_serve_shard_streams(tmp_path):
    """ClusterPlatform(mesh_shape=4) hands the mesh to every node: node0's
    cold start reads one shard stream a device from the origin, node1's
    streams every (unit, (mesh_tag, shard)) payload from node0 over the
    link, and both answer with the same logits."""
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype=torch.float32)
    model = transformer.build(cfg, device="cpu")
    store = WeightStore(str(tmp_path))
    deploy_model(store, model, "m", seed=3)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)))}
    n_units = len(model.unit_names())
    cl = ClusterPlatform(store, {"m": lambda: (model, batch)}, n_nodes=2,
                         cluster_bw_mbps=0, device="cpu", mesh_shape=4)
    try:
        outs = []
        for node in cl.nodes:
            pool = node.platform.pools["m"]
            assert pool.mesh_shape == 4
            inst = pool.acquire()
            logits, info = inst.invoke(batch)
            assert info["cold"] and inst.engine.mesh.size == 4
            R = [e for e in inst.last_load.trace.events if e.stage == "R"]
            assert {e.meta["shard"] for e in R} == {0, 1, 2, 3}
            assert len(R) == n_units * 4
            outs.append((logits, R))
            pool.release(inst, logical_now=0.0, cold=True)
        assert not any(e.meta.get("peer") for e in outs[0][1])
        assert all(e.meta.get("peer") for e in outs[1][1])
        assert cl.nodes[0].origin_reads() == n_units * 4
        assert cl.nodes[1].origin_reads() == 0
        assert cl.nodes[1].peer_reads() == n_units * 4
        assert torch.equal(outs[0][0], outs[1][0])
        tag = plan_tag(make_serving_mesh((1, 4), device="cpu"),
                       serve_rules())
        assert set(cl.placement.locate("m", "embed", (tag, 2))) == \
            {"node0", "node1"}
    finally:
        cl.flush()
