"""The port's serverless platform held against the JAX package's on the
CPU: the same Azure-like trace, replayed serially through both platforms
over one store the JAX package deployed (smollm-360m smoke, f32 compute;
the JAX side under ``REPRO_PALLAS=ref``), with a keep-alive that forces
evictions and a cache budget that forces cache evictions, gives equal
cold flags, pool stats, cache stats and router counts, one-shot logits
within 1e-4 and equal greedy tokens.  Also: the trace generator draws
the reference's invocations, a concurrent replay keeps the serial
replay's tokens, eviction frees an instance's tensors, the engine's
per-load instruments and the ``BatchedLMServer`` shim; and a one-shot
vision pair (resnet50 smoke and a narrow ViT) replayed through both
platforms."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.metrics import MetricsRegistry as JMetrics
from repro.models import transformer as jtransformer
from repro.models import vision as jvision
from repro.models.api import ArchConfig as JConfig
from repro.models.api import Family as JFamily
from repro.models.api import get_config as jget_config
from repro.serving import engine as jengine
from repro.serving import pool as jpool
from repro.serving import trace as jtrace
from repro.serving.api import GenerateSpec as JSpec
from repro.store import store as jstore
from repro_torch.core import ColdStartEngine
from repro_torch.metrics import MetricsRegistry
from repro_torch.models import transformer, vision
from repro_torch.models.api import ArchConfig, Family, get_config
from repro_torch.serving import (BatchedLMServer, GenerateSpec,
                                 ServerlessPlatform, reference_generate)
from repro_torch.serving import pool as tpool
from repro_torch.serving import trace as ttrace
from repro_torch.store.store import BandwidthModel, WeightStore
from torch_testlib import COLDSTART_TOL

torch.set_num_threads(2)

MODELS = ("m", "n")
KEEP_ALIVE = 20.0
PROMPT, N_NEW = 6, 4


# ---------------------------------------------------------------------------
# the trace generator draws the reference's invocations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_matches_reference(seed):
    for dur, n, models in ((3600.0, 2426, ("a", "b", "c")),
                           (240.0, 10, MODELS), (59.0, 3, ("x",))):
        got = ttrace.azure_like_trace(duration_s=dur, n_invocations=n,
                                      models=models, seed=seed)
        want = jtrace.azure_like_trace(duration_s=dur, n_invocations=n,
                                       models=models, seed=seed)
        assert [dataclasses.astuple(i) for i in got] == \
            [dataclasses.astuple(i) for i in want]
        assert ttrace.summarize(got) == jtrace.summarize(want)
    np.testing.assert_array_equal(
        ttrace.per_minute_envelope(60, 40.0, seed=seed),
        jtrace.per_minute_envelope(60, 40.0, seed=seed))


# ---------------------------------------------------------------------------
# one store, both platforms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    jcfg = dataclasses.replace(jget_config("smollm-360m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    js = jstore.WeightStore(root)
    for i, name in enumerate(MODELS):
        jstore.deploy_model(js, jm, name, jax.random.key(7 + i))
    tm = transformer.build(tcfg, device="cpu")
    tokens = {name: np.random.default_rng(20 + i).integers(
        0, tcfg.vocab_size, (1, 8)) for i, name in enumerate(MODELS)}
    return root, jm, tm, tokens


def _budget(root):
    """One and a half models' bytes: loading one evicts part of the
    other."""
    return int(1.5 * WeightStore(root).model_nbytes(MODELS[0]))


def _trace():
    return ttrace.azure_like_trace(duration_s=240.0, n_invocations=10,
                                   models=MODELS, seed=2)


def _replay_port(deployed, workload, *, concurrency=1, **kw):
    root, _, tm, tokens = deployed
    logits = []
    orig = tpool.FunctionInstance.invoke

    def invoke(self, batch):
        out, info = orig(self, batch)
        logits.append(out.float().numpy())
        return out, info

    store = WeightStore(root, BandwidthModel(bandwidth_mbps=400))
    builders = {name: (lambda name=name: (
        tm, {"tokens": torch.as_tensor(tokens[name])})) for name in MODELS}
    plat = ServerlessPlatform(store, builders, strategy="cicada",
                              keep_alive_s=KEEP_ALIVE, io_workers=1,
                              cache_budget_bytes=_budget(root), gen_slots=4,
                              gen_cache_len=32, device="cpu", **kw)
    rng = np.random.default_rng(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpool.FunctionInstance, "invoke", invoke)
        out = plat.run_trace(
            _trace(), lambda name: {"tokens": torch.as_tensor(tokens[name])},
            concurrency=concurrency,
            make_spec=None if workload == "oneshot" else
            (lambda name: GenerateSpec(
                prompt=rng.integers(0, tm.cfg.vocab_size, (PROMPT,)),
                n_new=N_NEW)))
    return plat, out, logits


def _replay_jax(deployed, workload):
    root, jm, _, tokens = deployed
    logits = []
    orig = jpool.FunctionInstance.invoke

    def invoke(self, batch):
        out, info = orig(self, batch)
        logits.append(np.asarray(out, np.float32))
        return out, info

    store = jstore.WeightStore(root, jstore.BandwidthModel(bandwidth_mbps=400))
    builders = {name: (lambda name=name: (
        jm, {"tokens": jnp.asarray(tokens[name], jnp.int32)}))
        for name in MODELS}
    rng = np.random.default_rng(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        mp.setattr(jpool.FunctionInstance, "invoke", invoke)
        plat = jengine.ServerlessPlatform(
            store, builders, strategy="cicada", keep_alive_s=KEEP_ALIVE,
            io_workers=1, cache_budget_bytes=_budget(root), gen_slots=4,
            gen_cache_len=32, metrics=JMetrics())
        trace = jtrace.azure_like_trace(duration_s=240.0, n_invocations=10,
                                        models=MODELS, seed=2)
        out = plat.run_trace(
            trace, lambda name: {"tokens": jnp.asarray(tokens[name],
                                                       jnp.int32)},
            make_spec=None if workload == "oneshot" else
            (lambda name: JSpec(
                prompt=rng.integers(0, jm.cfg.vocab_size,
                                    (PROMPT,)).astype(np.int32),
                n_new=N_NEW)))
    return plat, out, logits


@pytest.mark.parametrize("workload", ["oneshot", "generate"])
def test_serial_replay_matches_reference(deployed, workload):
    tplat, tout, tlog = _replay_port(deployed, workload)
    jplat, jout, jlog = _replay_jax(deployed, workload)
    cold = [r.cold for r in tout]
    assert cold == [r.cold for r in jout]
    assert True in cold[1:] and False in cold      # re-triggered cold starts
    assert [(r.req_id, r.model) for r in tout] == \
        [(r.req_id, r.model) for r in jout]
    for name in MODELS:
        assert dataclasses.asdict(tplat.pool_stats()[name]) == \
            dataclasses.asdict(jplat.pool_stats()[name])
        assert tplat.pool_stats()[name].evictions >= 1
    tcs, jcs = tplat.cache_stats(), jplat.cache_stats()
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    assert tcs.evictions > 0 and tcs.hits > 0 and tcs.pinned == 0
    trs, jrs = tplat.last_router_stats, jplat.last_router_stats
    assert (trs.submitted, trs.completed, trs.rejected) == \
        (jrs.submitted, jrs.completed, jrs.rejected) == (10, 10, 0)
    tsnap, jsnap = tplat.metrics_snapshot(), jplat.metrics_snapshot()
    for key in ("coldstart/loads", "router/cold", "router/warm",
                "weight_cache/hits", "weight_cache/evictions"):
        assert tsnap["counters"].get(key) == jsnap["counters"].get(key), key
    if workload == "oneshot":
        assert len(tlog) == len(jlog) == 10
        for a, b in zip(tlog, jlog):
            np.testing.assert_allclose(a, b, **COLDSTART_TOL)
        assert all(r.tokens is None for r in tout)
    else:
        for a, b in zip(tout, jout):
            assert list(a.tokens) == list(b.tokens)
            assert a.n_generated == N_NEW and len(a.tpot_s) == N_NEW - 1


def test_concurrent_generation_replay_keeps_serial_tokens(deployed):
    _, serial, _ = _replay_port(deployed, "generate")
    plat, conc, _ = _replay_port(deployed, "generate", concurrency=4)
    assert [r.req_id for r in conc] == [r.req_id for r in serial]
    for a, b in zip(serial, conc):
        assert list(a.tokens) == list(b.tokens)
    rs = plat.last_router_stats
    assert rs.completed == 10 and rs.max_in_flight >= 1
    st = plat.pool_stats()
    assert sum(p.cold_starts + p.warm_hits for p in st.values()) == 10
    assert all(p.gen_active == 0 and p.busy == 0 for p in st.values())


def test_eviction_drops_instance_tensors(deployed):
    plat, out, _ = _replay_port(deployed, "generate")
    inst = plat.pools[out[-1].model]._instances[0]
    assert inst.live and inst.scheduler is not None
    assert inst.last_load.params is not None
    n_live = sum(p.live for p in plat.pool_stats().values())
    assert plat.sweep(1e9) == n_live
    assert not inst.live and inst.scheduler is None
    assert inst.last_load.params is None and inst.last_load.logits is None
    assert inst.last_load.trace.events_for("E")    # the trace stays
    assert all(p.live == 0 for p in plat.pool_stats().values())
    # a later request loads again, from the cache
    again = plat.run_trace(_trace()[:1], None, make_spec=lambda name:
                           GenerateSpec(prompt=[1, 2, 3], n_new=2))
    assert again[0].cold and again[0].n_generated == 2


def test_engine_records_load_instruments_as_reference(deployed):
    root, jm, tm, tokens = deployed
    tm_reg, jm_reg = MetricsRegistry(), JMetrics()
    for _ in range(2):
        ColdStartEngine(tm, "m", WeightStore(root), metrics=tm_reg,
                        device="cpu").load(
            {"tokens": torch.as_tensor(tokens["m"])})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        for _ in range(2):
            JEngine(jm, "m", jstore.WeightStore(root),
                    metrics=jm_reg).load(
                {"tokens": jnp.asarray(tokens["m"], jnp.int32)})
    ts, js = tm_reg.snapshot(), jm_reg.snapshot()
    assert ts["counters"] == js["counters"] == {"coldstart/loads": 2.0}
    assert sorted(ts["histograms"]) == sorted(js["histograms"])
    for name, h in ts["histograms"].items():
        assert h["count"] == js["histograms"][name]["count"] == 2
    assert ColdStartEngine.UTIL_BUCKETS == JEngine.UTIL_BUCKETS
    assert tuple(tm_reg.histogram("coldstart/utilization").bounds) == \
        tuple(jm_reg.histogram("coldstart/utilization").bounds)


def test_batched_lm_server_matches_reference_generate(deployed):
    root, _, tm, _ = deployed
    params = ColdStartEngine(tm, "n", WeightStore(root), device="cpu").load(
        {"tokens": torch.tensor([[1, 2]])}).params
    prompts = torch.as_tensor(np.random.default_rng(9).integers(
        0, tm.cfg.vocab_size, (3, 5)))
    srv = BatchedLMServer(tm, params, max_batch=3, cache_len=16)
    out = srv.generate(prompts, n_new=4)
    assert out.shape == (3, 4) and out.dtype == torch.int32
    for b in range(3):
        assert out[b].tolist() == reference_generate(
            tm, params, prompts[b], n_new=4, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        BatchedLMServer(tm, params, max_batch=2, cache_len=16).generate(
            prompts, n_new=2)


def test_prewarm_and_scale_in_on_port_instances(deployed):
    """Capacity actions off the request path: prewarm loads an instance
    with its example batch (counted as a prewarm, not a cold start), the
    next request is warm, and scale_in evicts idle live instances."""
    plat, _, _ = _replay_port(deployed, "oneshot")
    pool = plat.pools["m"]
    plat.sweep(1e9)
    assert not pool.any_live()
    before = pool.stats()
    assert pool.prewarm(logical_now=0.0) is True
    st = pool.stats()
    assert st.live == 1 and st.prewarms == before.prewarms + 1
    assert st.cold_starts == before.cold_starts
    assert pool.prewarm() is False             # at capacity, already warm
    inst = pool.acquire()
    _, info = inst.invoke({"tokens": torch.tensor([[1, 2, 3]])})
    assert not info["cold"]
    pool.release(inst, logical_now=0.0, cold=False)
    assert inst.ensure_live() is False
    assert pool.scale_in(0) == 1 and not pool.any_live()
    assert pool.stats().evictions == before.evictions + 1


def test_vision_oneshot_replay_matches_reference(tmp_path, monkeypatch):
    """One-shot serving of a vision pair, resnet50 smoke and a 2-layer
    ViT of width 64 (test-only, set on both packages' tables), from f32
    stores the JAX package deployed, through both platforms with one
    unbounded WeightCache: equal cold flags, pool and cache stats, and
    logits within 1e-4."""
    vit_t = (2, 64, 4, 128, 8)
    monkeypatch.setitem(jvision.VIT, "vit_t", vit_t)
    monkeypatch.setitem(vision.VIT, "vit_t", vit_t)
    kw = dict(name="vit_t-test", vocab_size=10, vision_variant="vit_t",
              img_res=32)
    jcfgs = {"r": jget_config("resnet50", smoke=True),
             "v": JConfig(family=JFamily.VISION, **kw)}
    tcfgs = {"r": get_config("resnet50", smoke=True),
             "v": ArchConfig(family=Family.VISION, **kw)}
    root = str(tmp_path)
    js = jstore.WeightStore(root)
    jms = {n: jtransformer.build(c) for n, c in jcfgs.items()}
    for i, (n, m) in enumerate(jms.items()):
        jstore.deploy_model(js, m, n, jax.random.key(30 + i))
    tms = {n: transformer.build(c, device="cpu") for n, c in tcfgs.items()}
    images = {n: np.random.default_rng(40 + i).standard_normal(
        (1, 3, 32, 32)).astype(np.float32) for i, n in enumerate(jcfgs)}
    trace = ttrace.azure_like_trace(duration_s=240.0, n_invocations=10,
                                    models=tuple(jcfgs), seed=2)
    logits = {"port": [], "jax": []}

    def capture(mod, side):
        orig = mod.FunctionInstance.invoke

        def invoke(self, batch):
            out, info = orig(self, batch)
            logits[side].append(np.asarray(out, np.float32))
            return out, info
        monkeypatch.setattr(mod.FunctionInstance, "invoke", invoke)

    capture(tpool, "port")
    capture(jpool, "jax")
    tplat = ServerlessPlatform(
        WeightStore(root, BandwidthModel(bandwidth_mbps=400)),
        {n: (lambda n=n: (tms[n], {"image": torch.from_numpy(images[n])}))
         for n in tms}, strategy="cicada", keep_alive_s=KEEP_ALIVE,
        io_workers=1, cache_budget_bytes=0, device="cpu")
    tout = tplat.run_trace(trace, lambda n: {"image": torch.from_numpy(
        images[n])})
    with monkeypatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        jplat = jengine.ServerlessPlatform(
            jstore.WeightStore(root, jstore.BandwidthModel(
                bandwidth_mbps=400)),
            {n: (lambda n=n: (jms[n], {"image": jnp.asarray(images[n])}))
             for n in jms}, strategy="cicada", keep_alive_s=KEEP_ALIVE,
            io_workers=1, cache_budget_bytes=0, metrics=JMetrics())
        jout = jplat.run_trace(
            jtrace.azure_like_trace(duration_s=240.0, n_invocations=10,
                                    models=tuple(jcfgs), seed=2),
            lambda n: {"image": jnp.asarray(images[n])})
    cold = [r.cold for r in tout]
    assert cold == [r.cold for r in jout]
    assert True in cold[2:] and False in cold      # re-triggered cold starts
    assert [(r.req_id, r.model) for r in tout] == \
        [(r.req_id, r.model) for r in jout]
    for n in jcfgs:
        assert dataclasses.asdict(tplat.pool_stats()[n]) == \
            dataclasses.asdict(jplat.pool_stats()[n])
    tcs, jcs = tplat.cache_stats(), jplat.cache_stats()
    assert dataclasses.asdict(tcs) == dataclasses.asdict(jcs)
    assert tcs.hits > 0 and tcs.misses == sum(
        len(m.unit_names()) for m in tms.values())
    assert len(logits["port"]) == len(logits["jax"]) == 10
    for a, b in zip(logits["port"], logits["jax"]):
        assert a.shape == b.shape == (1, 10)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
