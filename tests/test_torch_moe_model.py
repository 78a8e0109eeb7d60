"""The port's MoE LMs against the JAX package's, mixtral-8x7b smoke (a
sliding window, a ring cache) and arctic-480b smoke (128-expert layout at
8 experts, a dense residual, full attention), f32 compute, from the same
weights: ``unit_apply`` and ``forward`` (with the aux loss), ``prefill`` +
``decode_step`` logits within 1e-4 of max |logit|, greedy tokens equal;
cold starts from JAX-deployed f32 and int8 stores under the five
strategies and from the f32 store cast at A; an int8-resident
(``compute_quant``) load against the reference's, with one
``quant_matmul`` call per weight product counted from the code; the
slotted scheduler's tokens equal ``reference_generate``'s and the JAX
scheduler's; and paged decode with prefix reuse for arctic and for
mixtral at ``sliding_window=0``, as ``tests/test_paged_kv.py`` runs it.
The JAX side runs with ``REPRO_PALLAS=ref``."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro.serving.decode import reference_generate as jgenerate
from repro.store import store as jstore
from repro_torch import quant as tquant
from repro_torch import tree as tree_util
from repro_torch.core import STRATEGIES
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from torch_testlib import coldstart_load, coldstart_setup

torch.set_num_threads(2)
ARCHS = ["mixtral-8x7b", "arctic-480b"]
LOGIT_TOL = 1e-4          # of max |logit|
CACHE_LEN = 64


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def make_pair(arch, **kw):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32, **kw)
    jm = jtransformer.LM(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return make_pair(request.param)


def within(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_unit_apply_and_forward_match(pair):
    jm, jparams, tm, tparams = pair
    tok = tokens(tm.cfg, 2, 24, 0)
    keys = jax.random.split(jax.random.key(1), len(jm.unit_names()))
    jst = {"batch": {"tokens": jnp.asarray(tok, jnp.int32)}}
    tst = {"batch": {"tokens": torch.as_tensor(tok)}}
    for name, k in zip(jm.unit_names(), keys):
        jp = jm.init_unit(name, k)
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        jst = jm.unit_apply(name, jp, jst)
        tst = tm.unit_apply(name, tp, tst)
        within(tst["logits" if name == "final" else "x"],
               jst["logits" if name == "final" else "x"])
    tok = tokens(tm.cfg, 2, 33, 1)
    jl, jaux = jm.forward(jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    tl, taux = tm.forward(tparams, {"tokens": torch.as_tensor(tok)})
    within(tl, jl)
    assert float(jaux) > 0
    assert abs(float(taux) - float(jaux)) <= 1e-5 * float(jaux)


def test_prefill_and_decode_match(pair):
    jm, jparams, tm, tparams = pair
    B, S = 2, 20
    tok = tokens(tm.cfg, B, S, 2)
    jc, tc = jm.init_cache(B, CACHE_LEN), tm.init_cache(B, CACHE_LEN)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok, jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(tok)}, tc)
    within(tl, jl)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))
    for t in range(S, S + 8):            # past mixtral's 16-token window
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt[:, None],
                                                          jnp.int32),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.as_tensor(nxt[:, None]),
                                torch.as_tensor(pos))
        within(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
    within(tc["s0"]["k"], jc["s0"]["k"])


def test_greedy_tokens_equal_jax(pair):
    jm, jparams, tm, tparams = pair
    for S in (8, 17):
        prompt = tokens(tm.cfg, 1, S, S)[0]
        want = jgenerate(jm, jparams, prompt, n_new=12, cache_len=CACHE_LEN)
        assert reference_generate(tm, tparams, prompt, n_new=12,
                                  cache_len=CACHE_LEN,
                                  device="cpu") == want


@pytest.fixture(scope="module", params=ARCHS)
def stores(request, tmp_path_factory):
    return coldstart_setup(str(tmp_path_factory.mktemp("store")),
                           arch=request.param)


def test_cold_starts_match_jax(stores):
    """Every strategy from the JAX-deployed f32 and int8 stores, and the
    f32 store cast to bf16 at A (cicada), against the JAX engine's
    cicada load of each; the assembled params' forward equals the
    in-pipeline logits."""
    tm, _, batch, _ = stores
    for case in ("f32", "int8"):
        for strategy in sorted(STRATEGIES):
            res, want = coldstart_load(stores, strategy, case)
            within(res.logits, want)
    res, want = coldstart_load(stores, "cicada", "bf16-cast")
    within(res.logits, want)
    assert res.params["blocks"]["s0"]["moe"]["experts"]["wg"].dtype == \
        torch.bfloat16
    warm, _ = tm.forward(res.params, batch)
    torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)


def test_compute_quant_matches_jax_with_one_product_per_weight(
        stores, monkeypatch):
    """The int8-resident load keeps every matrix of the store int8, the
    3-D expert leaves and the router included, and its logits match the
    JAX engine's ``compute_quant`` load.  One forward makes one
    ``quant_matmul`` call per weight product: 4 attention products, 3 per
    expert and 3 for a dense residual in each layer, and the head."""
    tm, ts, batch, _ = stores
    cfg = tm.cfg
    jm = jtransformer.build(dataclasses.replace(
        jget_config(cfg.name.removesuffix("-smoke"), smoke=True),
        compute_dtype=jnp.float32))
    jres = JEngine(jm, "q", jstore.WeightStore(ts.root), strategy="cicada",
                   compute_quant=True).load(
        {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)})
    res = TEngine(tm, "q", ts, strategy="cicada", chunk_bytes=1 << 14,
                  compute_quant=True, device="cpu").load(batch)
    within(res.logits, jres.logits)
    blk = res.params["blocks"]["s0"]
    for leaf in (blk["moe"]["router"], *blk["moe"]["experts"].values()):
        assert tquant.is_quant(leaf)
    assert tuple(blk["moe"]["experts"]["wd"].q.shape) == (
        cfg.n_layers, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff, cfg.d_model)
    calls = []
    real = tops.quant_matmul
    monkeypatch.setattr(tops, "quant_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    warm, _ = tm.forward(res.params, batch)
    per_layer = 4 + 3 * cfg.n_experts + (3 if cfg.dense_residual else 0)
    assert len(calls) == cfg.n_layers * per_layer + 1
    torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)
    carried = ttransformer.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jres.params), device="cpu")
    assert tquant.is_quant(carried["blocks"]["s0"]["moe"]["experts"]["wg"])
    torch.testing.assert_close(tm.forward(carried, batch)[0], warm,
                               rtol=0, atol=0)


def _concurrent(sched, specs):
    out = [None] * len(specs)

    def run(i):
        out[i] = sched.generate(specs[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def test_slotted_scheduler_equals_reference(pair):
    """Four concurrent requests (one past mixtral's window) equal the
    serial reference, and the first equals the JAX scheduler's."""
    jm, jparams, tm, tparams = pair
    prompts = [tokens(tm.cfg, 1, n, 10 + n)[0] for n in (5, 9, 13, 21)]
    sched = DecodeScheduler(tm, tparams, n_slots=4, cache_len=CACHE_LEN)
    results = _concurrent(sched, [GenerateSpec(prompt=p, n_new=8)
                                  for p in prompts])
    for p, r in zip(prompts, results):
        assert r.tokens == reference_generate(tm, tparams, p, n_new=8,
                                              cache_len=CACHE_LEN,
                                              device="cpu")
    assert sched.stats()["max_occupancy"] >= 2
    want = JScheduler(jm, jparams, n_slots=2, cache_len=CACHE_LEN).generate(
        JSpec(prompt=prompts[0].astype(np.int32), n_new=8)).tokens
    assert results[0].tokens == want


@pytest.mark.parametrize("arch,kw", [("arctic-480b", {}),
                                     ("mixtral-8x7b", {"sliding_window": 0})],
                         ids=["arctic", "mixtral-full-attention"])
def test_paged_prefix_reuse_equals_reference(arch, kw):
    """A full-attention MoE pages its KV and shares prefixes: two
    requests over one shared 2-page prefix (the second hits it) equal
    the serial reference, and the page pool's invariants hold."""
    _, _, tm, tparams = make_pair(arch, **kw)
    assert tm.supports_prefix_cache and tm.paged_kinds() == ["moe"]
    pt = 8
    sched = DecodeScheduler(tm, tparams, n_slots=2, cache_len=CACHE_LEN,
                            kv_page_tokens=pt, kv_max_seq=CACHE_LEN)
    shared = tokens(tm.cfg, 1, 2 * pt, 7)[0]
    for i, n in enumerate((5, 3)):
        p = np.concatenate([shared, tokens(tm.cfg, 1, n, 8 + i)[0]])
        r = sched.generate(GenerateSpec(prompt=p, n_new=5, seed=i))
        assert r.tokens == reference_generate(tm, tparams, p, n_new=5,
                                              cache_len=CACHE_LEN, seed=i,
                                              device="cpu")
    assert sched.kvpool.stats().prefix_hits == 2
    assert sched.kvpool.stats().pinned == 0
    sched.kvpool.check_invariants()
    assert tree_util.leaves(sched._cache) == [None, None]


def test_decode_step_rows_hold_no_moe_op_that_depends_on_the_batch():
    """The rows probe (``ab.probe_rows``) on one decode step at B = 4
    against B = 1 finds no op of the MoE FFN whose result on the shared
    row depends on the batch: the router's fixed-order tree, the
    selections, the combine, and no batch-wide aux loss in a decode step
    (the CPU's matmuls in ``quant.py`` may differ by M; on the card the
    rows probe of ``chip_smoke.py`` holds them too)."""
    from repro_torch.kernels import ab
    for arch in ARCHS:
        cfg = dataclasses.replace(tget_config(arch, smoke=True),
                                  compute_dtype=torch.float32)
        tm = ttransformer.build(cfg, device="cpu")
        params = tm.init(0)
        prompts = list(tokens(cfg, 1, 12, 9)[0][:n] for n in (12, 5, 8, 10))
        probe = ab.probe_rows(tm, params, prompts, cache_len=CACHE_LEN)
        assert probe["misaligned"] is None and probe["compared"] > 0
        assert not [s for s in probe["sources"] if "models/moe.py" in s], \
            probe["sources"]
