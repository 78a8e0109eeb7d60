"""The port's audio encoder (hubert-xlarge smoke: non-causal, layernorm,
tanh GELU, a frame projection and an encoder head) and VLM backbone
(internvl2-76b smoke: image rows projected ahead of the tokens) against
the JAX package's, f32 compute, from the same weights: forward logits
within 1e-4 of max |logit| on the launcher's example batches, and for the
VLM ``prefill`` + ``decode_step`` with positions counting the image rows;
cold starts from JAX-deployed f32 and int8 stores (five strategies, and
``compute_quant``); ``supports_prefix_cache`` false for both, as in the
reference; the VLM's token-only requests through the slotted and paged
schedulers equal ``reference_generate``; and ``example_batch`` bit-equal
to the reference's for both families.  The JAX side runs with
``REPRO_PALLAS=ref``."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.launch import serve as jserve
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.store import store as jstore
from repro_torch.core import STRATEGIES
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from repro_torch.store import store as tstore

torch.set_num_threads(2)
ARCHS = ["hubert-xlarge", "internvl2-76b"]
LOGIT_TOL = 1e-4          # of max |logit|


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def cfgs(arch):
    return (dataclasses.replace(jget_config(arch, smoke=True),
                                compute_dtype=jnp.float32),
            dataclasses.replace(tget_config(arch, smoke=True),
                                compute_dtype=torch.float32))


def within(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def batches(tcfg, seq=24):
    """The launcher's example batch at f32, for both packages."""
    tb = {k: v.float() if v.is_floating_point() else v
          for k, v in tserve.example_batch(tcfg, seq).items()}
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = cfgs(request.param)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


def test_forward_and_units_match(pair):
    jm, jparams, tm, tparams = pair
    jb, tb = batches(tm.cfg)
    jl, _ = jm.forward(jparams, jb)
    tl, _ = tm.forward(tparams, tb)
    assert tl.shape == (1, 24, tm.cfg.vocab_size)
    within(tl, jl)
    keys = jax.random.split(jax.random.key(1), len(jm.unit_names()))
    jst, tst = {"batch": jb}, {"batch": tb}
    for name, k in zip(jm.unit_names(), keys):
        jp = jm.init_unit(name, k)
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        jst = jm.unit_apply(name, jp, jst)
        tst = tm.unit_apply(name, tp, tst)
        within(tst["logits" if name == "final" else "x"],
               jst["logits" if name == "final" else "x"])


def test_vlm_prefill_and_decode_match():
    """The image rows come first and count in the positions: decode
    resumes at n_img + n_tok, with a zero-length image per step."""
    jcfg, tcfg = cfgs("internvl2-76b")
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(2))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    B, n_img, n_tok = 2, 6, 10
    tok = rng.integers(0, tcfg.vocab_size, (B, n_tok))
    img = rng.standard_normal((B, n_img, tcfg.frontend_dim)).astype(
        np.float32)
    jc, tc = jm.init_cache(B, 48), tm.init_cache(B, 48)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok, jnp.int32),
                                  "img": jnp.asarray(img)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(tok),
                                  "img": torch.from_numpy(img)}, tc)
    within(tl, jl)
    nxt = np.array(jnp.argmax(jl[:, -1], -1))
    for t in range(n_img + n_tok, n_img + n_tok + 6):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt[:, None],
                                                          jnp.int32),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.as_tensor(nxt[:, None]),
                                torch.as_tensor(pos))
        within(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
    within(tc["s0"]["v"], jc["s0"]["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cold_starts_match_jax(arch, tmp_path):
    """From JAX-deployed f32 and int8 stores: the five strategies on the
    f32 store against the JAX engine's cicada load, cicada on the int8
    store (dequantized at A), and ``compute_quant`` against the JAX
    engine's int8-resident load; the assembled params' forward equals
    the in-pipeline logits."""
    jcfg, tcfg = cfgs(arch)
    jm = jtransformer.build(jcfg)
    js = jstore.WeightStore(str(tmp_path))
    jstore.deploy_model(js, jm, "m", jax.random.key(7))
    jstore.deploy_model(js, jm, "q", jax.random.key(7), quant="int8")
    jb, tb = batches(tcfg, seq=16)
    want = {(n, cq): JEngine(jm, n, js, strategy="cicada",
                             compute_quant=cq).load(jb).logits
            for n, cq in (("m", False), ("q", False), ("q", True))}
    tm = ttransformer.build(tcfg, device="cpu")
    ts = tstore.WeightStore(str(tmp_path),
                            tstore.BandwidthModel(bandwidth_mbps=400))
    for strategy in sorted(STRATEGIES):
        res = TEngine(tm, "m", ts, strategy=strategy, chunk_bytes=1 << 14,
                      device="cpu").load(tb)
        within(res.logits, want[("m", False)])
    for cq in (False, True):
        res = TEngine(tm, "q", ts, strategy="cicada", chunk_bytes=1 << 14,
                      compute_quant=cq, device="cpu").load(tb)
        within(res.logits, want[("q", cq)])
        warm, _ = tm.forward(res.params, tb)
        torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)


def test_no_prefix_cache_for_audio_and_vlm():
    for arch in ARCHS:
        jm = jtransformer.build(jget_config(arch, smoke=True))
        tm = ttransformer.build(tget_config(arch, smoke=True), device="cpu")
        assert tm.supports_prefix_cache is False
        assert jm.supports_prefix_cache is False
        assert tm.paged_kinds() == jm.paged_kinds() == ["attn"]


def test_example_batches_bit_equal_to_the_reference():
    """The bf16 frames and image rows are the reference's bits (float64
    draws converted as ``jnp.asarray`` converts them), the tokens its
    integers, at the smoke and the full frontend widths."""
    for arch in ARCHS:
        for smoke, seq in ((True, 32), (False, 256)):
            t = tserve.example_batch(tget_config(arch, smoke=smoke), seq)
            j = jserve.example_batch(jget_config(arch, smoke=smoke), seq)
            assert sorted(t) == sorted(j)
            for k in t:
                want = np.asarray(j[k])
                if t[k].dtype == torch.bfloat16:
                    assert want.dtype.name == "bfloat16"
                    np.testing.assert_array_equal(
                        t[k].view(torch.int16).numpy(),
                        want.view(np.int16))
                else:
                    np.testing.assert_array_equal(t[k].numpy(), want)
    vlm = tserve.example_batch(tget_config("internvl2-76b", smoke=True))
    assert vlm["img"].shape == (1, 8, 48) and vlm["tokens"].shape == (1, 24)


def test_vlm_schedulers_equal_reference():
    """Token-only VLM requests (no image rows) through the slotted and
    the paged scheduler equal the serial reference."""
    _, tcfg = cfgs("internvl2-76b")
    tm = ttransformer.build(tcfg, device="cpu")
    params = tm.init(0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tcfg.vocab_size, (n,)) for n in (4, 9, 17)]
    want = [reference_generate(tm, params, p, n_new=6, cache_len=48,
                               device="cpu") for p in prompts]
    for pt in (None, 8):
        sched = DecodeScheduler(tm, params, n_slots=3, cache_len=48,
                                kv_page_tokens=pt)
        out = [None] * 3

        def run(i):
            out[i] = sched.generate(GenerateSpec(prompt=prompts[i], n_new=6))

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [r.tokens for r in out] == want
