"""Shard-granular cold starts on a logical (1, N) mesh, on the CPU: each
test of the reference's ``tests/test_sharded_coldstart.py`` on the port.

Every device of the port's mesh lies on one physical device, so a mesh
load must equal the port's single-device load bit for bit, logits and
params; it must also agree with the JAX package's single-device load and
warm forward within 1e-4 (f32 compute), and generate the same greedy
tokens.  The reference's own warm forward is sharded and held to 5%; the
port's runs on the leaves the shards committed.
"""
import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving.decode import reference_generate as jgenerate
from repro.store.store import WeightStore as JStore
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine
from repro_torch.core import shards as shards_mod
from repro_torch.core.shards import plan_unit
from repro_torch.distributed.sharding import leaf_specs, serve_rules
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving import InstancePool
from repro_torch.serving.decode import reference_generate
from repro_torch.store.cache import WeightCache
from repro_torch.store.store import WeightStore, deploy_model, slice_byte_runs
from torch_testlib import COLDSTART_TOL

torch.set_num_threads(2)

# one per family with distinct sharding behaviour: dense (smollm's
# n_heads=3 exercises the non-divisible fallback), MoE (expert axis),
# hybrid (rglru + attn pattern units)
ARCHS = ["smollm-360m", "mixtral-8x7b", "recurrentgemma-2b"]


class CountingStore(WeightStore):
    """A WeightStore counting whole-unit reads and shard-stream opens."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._read_lock = threading.Lock()
        self.reset()

    def read_unit(self, *a, **kw):
        with self._read_lock:
            self.unit_reads += 1
        return super().read_unit(*a, **kw)

    def open_unit(self, *a, **kw):
        with self._read_lock:
            self.shard_opens += 1
        return super().open_unit(*a, **kw)

    def reset(self):
        self.unit_reads = 0
        self.shard_opens = 0


def mesh(*shape):
    return make_serving_mesh(shape, device="cpu")


def _cfg(arch, **over):
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=torch.float32, **over)


def _batch(cfg):
    return {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 16)))}


def _deploy(tmp_path, arch, name="m", **over):
    cfg = _cfg(arch, **over)
    model = transformer.build(cfg, device="cpu")
    store = CountingStore(str(tmp_path))
    deploy_model(store, model, name, seed=7)
    return cfg, model, store, _batch(cfg)


def _deploy_int8(tmp_path, name="q8"):
    """An int8 deployment whose sharded leaves clear RUN_FLOOR_BYTES at one
    byte an element: d_ff / 4 = 1024-byte column runs.  The attention
    projections (3 heads on a 4-way mesh) replicate."""
    cfg = _cfg("smollm-360m", name=name, d_ff=4096, vocab_size=4096)
    model = transformer.build(cfg, device="cpu")
    store = CountingStore(str(tmp_path))
    deploy_model(store, model, name, seed=11, quant="int8")
    return cfg, model, store, _batch(cfg)


def _engine(model, store, batch, *, name="m", strategy="cicada", **kw):
    eng = ColdStartEngine(model, name, store, strategy=strategy,
                          device="cpu", **kw)
    eng.warmup(batch)
    return eng


def _same_params(a, b):
    fa, fb = tree_util.leaves_with_path(a), tree_util.leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _n_sharded(res):
    return sum(not s.is_fully_replicated
               for s in tree_util.leaves(res.shardings))


def _jax_side(store_dir, arch, tokens, n_new):
    """The JAX package's single-device load of the same store: logits,
    warm forward and greedy tokens (f32 compute, ref kernels)."""
    cfg = dataclasses.replace(jget_config(arch, smoke=True),
                              compute_dtype=jnp.float32)
    jm = jtransformer.build(cfg)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        res = JEngine(jm, "m", JStore(store_dir)).load(batch)
        warm, _ = jm.forward(res.params, batch)
        toks = jgenerate(jm, res.params, tokens[0], n_new=n_new)
    return (np.asarray(res.logits, np.float32), np.asarray(warm, np.float32),
            [int(t) for t in toks])


# ---------------------------------------------------------------------------
# byte-range planning
# ---------------------------------------------------------------------------

def test_slice_byte_runs_match_numpy():
    rng = np.random.default_rng(0)
    for shape in [(8,), (6, 8), (4, 6, 8), (3, 5, 7, 2)]:
        arr = rng.standard_normal(shape).astype(np.float32)
        raw = arr.tobytes()
        for _ in range(8):
            index = []
            for dim in shape:
                if rng.random() < 0.4:
                    index.append(slice(None))
                else:
                    a = int(rng.integers(0, dim))
                    b = int(rng.integers(a + 1, dim + 1))
                    index.append(slice(a, b))
            index = tuple(index)
            runs = slice_byte_runs(shape, arr.itemsize, index)
            got = b"".join(raw[o:o + n] for o, n in runs)
            assert got == np.ascontiguousarray(arr[index]).tobytes()


# ---------------------------------------------------------------------------
# sharded loads on the logical mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bit_identity_vs_single_device(tmp_path, arch):
    """The (1, 4) load answers with logits and params bit-equal to the
    single-device load, through one shard stream a device, with some
    leaves laid out sharded; against the JAX package's single-device
    load, its logits and warm forward agree within 1e-4 and its greedy
    tokens are equal."""
    cfg, model, store, batch = _deploy(tmp_path, arch)
    ref = _engine(model, store, batch).load(batch)
    res = _engine(model, store, batch, mesh=mesh(1, 4)).load(batch)

    assert torch.equal(res.logits, ref.logits)
    _same_params(ref.params, res.params)
    assert _n_sharded(res) > 0           # the mesh is actually used
    R = [e for e in res.trace.events if e.stage == "R"]
    assert {e.meta.get("shard") for e in R if e.meta} == {0, 1, 2, 3}

    n_new = 4
    j_logits, j_warm, j_tokens = _jax_side(str(tmp_path), arch,
                                           batch["tokens"].numpy(), n_new)
    np.testing.assert_allclose(res.logits.numpy(), j_logits,
                               **COLDSTART_TOL)
    warm, _ = model.forward(res.params, batch)
    np.testing.assert_allclose(warm.numpy(), j_warm, **COLDSTART_TOL)
    assert reference_generate(model, res.params, batch["tokens"][0].numpy(),
                              n_new=n_new, device="cpu") == j_tokens


def test_second_cold_start_hits_cache_per_shard(tmp_path):
    """With the shared WeightCache, every (unit, shard) stream of a second
    cold start onto the same mesh is served from the cache: zero more
    store opens, identical logits."""
    cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    cache = WeightCache(None)
    n_units = len(model.unit_names())

    store.reset()
    r1 = _engine(model, store, batch, mesh=mesh(1, 4),
                 cache=cache).load(batch)
    assert store.shard_opens == n_units * 4      # one open per stream
    assert store.unit_reads == 0                 # no whole-unit reads

    r2 = _engine(model, store, batch, mesh=mesh(1, 4),
                 cache=cache).load(batch)
    assert store.shard_opens == n_units * 4      # zero-read per shard
    st = cache.stats()
    assert st.misses == n_units * 4
    assert st.hits == n_units * 4
    assert torch.equal(r2.logits, r1.logits)
    assert cache.stats().pinned == 0             # pins checked in

    R = [e for e in r2.trace.events if e.stage == "R"]
    assert all(e.meta and e.meta.get("cached") for e in R)


def test_pool_mesh_knob_and_scale_out(tmp_path):
    """InstancePool(mesh_shape=4) wires the mesh through provisioning; a
    scale-out cold start of a second instance is served per shard from
    the shared cache without re-reading the store."""
    cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    cache = WeightCache(None)
    pool = InstancePool("m", lambda: (model, batch), store,
                        strategy="cicada", max_instances=2, cache=cache,
                        mesh_shape=4, device="cpu")
    i1 = pool.acquire()
    i2 = pool.acquire()
    assert i1.mesh.shape == {"data": 1, "model": 4}
    store.reset()
    logits1, info1 = i1.invoke(batch)
    assert info1["cold"]
    opens = store.shard_opens
    assert opens > 0
    logits2, info2 = i2.invoke(batch)
    assert info2["cold"]
    assert store.shard_opens == opens            # all shards cache-served
    assert torch.equal(logits1, logits2)
    pool.release(i1, logical_now=0.0, cold=True)
    pool.release(i2, logical_now=0.0, cold=True)


def test_non_divisible_axis_falls_back_to_replication(tmp_path):
    """Axes that do not divide their dimension resolve to replication:
    smollm's n_heads=3 on a 4-way mesh replicates the attention
    projections while the FFN stays sharded; under a config whose every
    sharded dim is indivisible the whole plan replicates, and the load
    still produces the deployed bytes."""
    cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    m4 = mesh(1, 4)
    specs = leaf_specs(model.abstract_unit("block_000"), m4, serve_rules())
    assert tuple(specs["attn/wq"].spec) == ()            # 3 heads % 4
    assert any(ax is not None for ax in specs["mlp/wg"].spec)

    odd_cfg = _cfg("smollm-360m", name="odd", d_model=54, n_heads=3,
                   n_kv_heads=1, d_ff=150, vocab_size=510)
    odd_model = transformer.build(odd_cfg, device="cpu")
    deploy_model(store, odd_model, "odd", seed=3)
    plan = plan_unit(store, "odd", "block_000",
                     odd_model.abstract_unit("block_000"), m4,
                     serve_rules())
    assert all(all(ax is None for ax in s.spec)
               for s in plan.specs.values())
    obatch = _batch(odd_cfg)
    ref = _engine(odd_model, store, obatch, name="odd").load(obatch)
    res = _engine(odd_model, store, obatch, mesh=m4,
                  name="odd").load(obatch)
    assert torch.equal(res.logits, ref.logits)
    _same_params(ref.params, res.params)


def test_mesh_of_one_degenerates_to_seed_path(tmp_path):
    """mesh=(1, 1) is exactly the seed pipeline: unit-granular whole
    reads, no shard streams, identical logits and no shardings."""
    cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    ref = _engine(model, store, batch).load(batch)
    eng = _engine(model, store, batch, mesh=mesh(1, 1))
    assert eng.mesh is None                      # degenerate normalization
    store.reset()
    res = eng.load(batch)
    assert store.unit_reads == len(model.unit_names())
    assert store.shard_opens == 0
    assert torch.equal(res.logits, ref.logits)
    assert res.shardings is None
    R = [e for e in res.trace.events if e.stage == "R"]
    assert all(not (e.meta and "shard" in e.meta) for e in R)


def test_fused_strategy_places_params_on_mesh(tmp_path):
    """Non-decoupled strategies (PISeL/mini) keep unit-granular fused
    retrieval but still lay their steady-state params out on the mesh."""
    cfg, model, store, batch = _deploy(tmp_path, "mixtral-8x7b")
    ref = _engine(model, store, batch, strategy="mini").load(batch)
    store.reset()
    res = _engine(model, store, batch, mesh=mesh(1, 4),
                  strategy="mini").load(batch)
    assert store.unit_reads == len(model.unit_names())   # fused reads
    assert store.shard_opens == 0
    assert torch.equal(res.logits, ref.logits)
    _same_params(ref.params, res.params)
    assert _n_sharded(res) > 0
    # mixtral's experts shard over the expert axis
    assert any(s.spec and s.spec[1] == "model" for p, s in
               tree_util.leaves_with_path(res.shardings)
               if p[-2:] == ("experts", "wg"))


# ---------------------------------------------------------------------------
# int8 shard streaming: dequant/cast leaves get shard plans too
# ---------------------------------------------------------------------------

def test_int8_leaves_get_ranged_shard_plans(tmp_path):
    """Every int8 leaf whose resolved spec is sharded streams byte-range
    pieces (values + per-column scale slices), and its allocation holds
    the transformed dtype."""
    cfg, model, store, batch = _deploy_int8(tmp_path)
    plan = plan_unit(store, "q8", "block_000",
                     model.abstract_unit("block_000"), mesh(1, 4),
                     serve_rules())
    saw_sharded_quant = 0
    for leaf, sharding in plan.specs.items():
        if not plan.quant[leaf]:
            continue
        assert plan.transformed[leaf] and \
            plan.out_dtype[leaf] == torch.float32
        pieces = [p for sh in plan.pieces for p in sh if p.leaf == leaf]
        if sharding.is_fully_replicated:
            continue                     # replication fallback (n_heads=3)
        saw_sharded_quant += 1
        assert pieces and all(p.index is not None for p in pieces), leaf
        # the scale bytes ride along in the stream's cost model
        for p in pieces:
            idx = p.index
            lo = 0 if idx[-1].start is None else idx[-1].start
            hi = plan.shapes[leaf][-1] if idx[-1].stop is None \
                else idx[-1].stop
            assert p.nbytes >= (hi - lo) * 4
    assert saw_sharded_quant >= 3            # mlp wg/wu/wd at least


@pytest.mark.parametrize("width", [2, 4])
def test_int8_sharded_bit_identical_to_whole_read(tmp_path, monkeypatch,
                                                  width):
    """An int8 cold start on a mesh of {2, 4} devices streams shards, runs
    one weight_transform a transformed piece on the placement lanes, and
    gives logits AND params bit-equal to the whole-read dequant path."""
    cfg, model, store, batch = _deploy_int8(tmp_path)
    ref = _engine(model, store, batch, name="q8").load(batch)
    m = mesh(1, width)
    eng = _engine(model, store, batch, mesh=m, name="q8")
    calls = []
    real = shards_mod.ops.weight_transform

    def spy(w, scale=None, **kw):
        calls.append(tuple(w.shape))
        return real(w, scale, **kw)
    monkeypatch.setattr(shards_mod.ops, "weight_transform", spy)
    store.reset()
    res = eng.load(batch)
    assert store.unit_reads == 0             # no whole-unit fallback reads
    assert store.shard_opens == len(model.unit_names()) * width
    assert len(calls) == sum(eng._plan(u).n_transformed()
                             for u in model.unit_names())
    assert torch.equal(res.logits, ref.logits)
    _same_params(ref.params, res.params)
    assert _n_sharded(res) > 0


@pytest.mark.parametrize("store_kind,adt", [("f32", None),
                                             ("f32", torch.bfloat16),
                                             ("int8", torch.bfloat16)])
def test_tiny_chunks_many_lanes_hold_the_bytes(tmp_path, monkeypatch,
                                               store_kind, adt):
    """Every buffer that several placement lanes write is allocated when
    the unit's shard data is made, before any lane starts (so no lane
    writes a block whose last use is pending on another stream); a late
    leaf gathers into its host tensor, every other slice into one of its
    own.  A load read in 64-byte chunks by 16 I/O workers and the four
    lanes of a (1, 4) mesh, with the interpreter switching threads every
    10 us, gives params and logits bit-equal to the single-device load.  The commit floor is lowered to 16 KiB a device,
    so that the smoke widths commit some leaves piece by piece and leave
    others late."""
    monkeypatch.setattr(shards_mod, "COMMIT_FLOOR_BYTES", 16384)
    if store_kind == "int8":
        cfg, model, store, batch = _deploy_int8(tmp_path, name="m")
    else:
        cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    m = mesh(1, 4)
    eng = _engine(model, store, batch, mesh=m, apply_dtype=adt,
                  chunk_bytes=64, io_workers=16)
    n_eager = n_late = 0
    for u in model.unit_names():
        plan = eng._plan(u)
        data = shards_mod.ShardedUnitData(plan)
        for p in (p for ps in plan.pieces for p in ps):
            if p.index is None:
                continue
            eager = plan.transformed[p.leaf] or plan.commit[p.leaf]
            assert (p.leaf in data._dev) == eager, (u, p.leaf)
            dest = data.host_dest(p.leaf, p.index)
            assert (dest is None) == eager, (u, p.leaf)
            n_eager += eager
            n_late += not eager
    assert n_eager > 0 and (n_late > 0 or adt is not None)
    ref = _engine(model, store, batch, apply_dtype=adt).load(batch)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        for _ in range(2):
            res = eng.load(batch)
            assert torch.equal(res.logits, ref.logits)
            _same_params(ref.params, res.params)
    finally:
        sys.setswitchinterval(interval)


def test_admission_window_bounds_the_stream_threads(tmp_path):
    """A unit's shard streams are submitted when the unit is admitted, so
    at most ``io_workers`` units' streams hold I/O threads: with two
    workers and four shards no more than 8 stream threads ever exist,
    not one a (unit, shard); the load still equals the single-device
    load."""
    cfg, model, store, batch = _deploy(tmp_path, "smollm-360m")
    seen = []
    real_open = store.open_unit

    def open_unit(*a, **kw):
        seen.append(sum(t.name.startswith("cicada-io")
                        for t in threading.enumerate()))
        return real_open(*a, **kw)
    store.open_unit = open_unit
    ref = _engine(model, store, batch).load(batch)
    res = _engine(model, store, batch, mesh=mesh(1, 4),
                  io_workers=2).load(batch)
    n_units = len(model.unit_names())
    assert len(seen) == n_units * 4 and n_units * 4 > 8
    assert max(seen) <= 8
    assert torch.equal(res.logits, ref.logits)
    _same_params(ref.params, res.params)


def test_per_shard_transform_subrows_in_trace(tmp_path):
    """Per-shard transforms are trace rows of their own: every transformed
    shard emits a 'T' event tagged with its shard, the Gantt gains a
    Transform row, and the events stay off the default busy-time stages."""
    cfg, model, store, batch = _deploy_int8(tmp_path)
    res = _engine(model, store, batch, mesh=mesh(1, 4),
                  name="q8").load(batch)
    tr = res.trace

    T = [e for e in tr.events if e.stage == "T"]
    assert T, "per-shard transforms emitted no T events"
    assert all(e.meta and "shard" in e.meta for e in T)
    assert {e.meta["shard"] for e in T} == set(range(4))
    assert all(e.t_end >= e.t_start for e in T)
    assert {e.layer for e in T} <= set(model.unit_names())
    assert "block_000" in {e.layer for e in T}

    assert "Transform" in tr.render_gantt()
    assert tr.summary()["work_T"] > 0.0
    assert tr.busy_time(("T",)) > 0.0
    assert tr.busy_time() == tr.busy_time(("L", "A", "E"))


def test_int8_second_cold_start_zero_read_per_shard(tmp_path):
    """With the shared WeightCache, the second int8 cold start is served
    entirely from cached shard payloads (int8 values + scale slices): zero
    more store opens, identical logits."""
    cfg, model, store, batch = _deploy_int8(tmp_path)
    cache = WeightCache(None)
    n_units = len(model.unit_names())

    store.reset()
    r1 = _engine(model, store, batch, mesh=mesh(1, 4), cache=cache,
                 name="q8").load(batch)
    assert store.shard_opens == n_units * 4
    assert store.unit_reads == 0

    r2 = _engine(model, store, batch, mesh=mesh(1, 4), cache=cache,
                 name="q8").load(batch)
    assert store.shard_opens == n_units * 4      # zero-read per shard
    st = cache.stats()
    assert st.misses == n_units * 4 and st.hits == n_units * 4
    assert torch.equal(r2.logits, r1.logits)
    R = [e for e in r2.trace.events if e.stage == "R"]
    assert R and all(e.meta and e.meta.get("cached") for e in R)
    assert cache.stats().pinned == 0


def test_launcher_mesh_serves_the_trace(tmp_path, capsys):
    """``--mesh 4`` on the CPU: four logical devices on the one device,
    the store with four channels, and the replay's cold flags and pool
    counts those of the single-device replay."""
    args = ["--invocations", "4", "--duration", "60", "--keep-alive", "20",
            "--bandwidth-mbps", "0", "--device", "cpu",
            "--store", str(tmp_path)]
    flat = tserve.main(args)["cicada"]
    capsys.readouterr()
    got = tserve.main(args + ["--mesh", "4"])["cicada"]
    out = capsys.readouterr().out
    assert "mesh: (1, 4) = 4 logical devices on one physical device (cpu" \
        in out
    assert [(r.req_id, r.cold) for r in got] == \
        [(r.req_id, r.cold) for r in flat]
    assert 0 < sum(r.cold for r in got) < len(got)
