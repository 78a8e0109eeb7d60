"""The port's dense LM against the JAX package's on smollm-360m smoke at
f32 compute, from the same weights (``params_from_numpy``): per-unit
``unit_apply``, ``forward``, ``prefill`` + ``decode_step`` logits within
1e-4, and greedy ``reference_generate`` tokens exactly equal.  The logits
parity (``forward``, ``prefill`` + ``decode_step``) also holds for the
other dense geometries: yi-9b (GQA rep 4), codeqwen1.5-7b (rep 1) and
h2o-danube-3-4b (rep 4 with a sliding window, whose decode cache is a
ring).  The JAX side runs with ``REPRO_PALLAS=ref``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving.decode import reference_generate as jgenerate
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving.decode import reference_generate as tgenerate

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "smollm-360m"
DENSE = ["smollm-360m", "yi-9b", "codeqwen1.5-7b", "h2o-danube-3-4b"]


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def make_pair(arch):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH)


@pytest.fixture(scope="module", params=DENSE)
def dense_pair(request):
    return make_pair(request.param)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_unit_apply_matches(pair):
    jm, _, tm, _ = pair
    keys = jax.random.split(jax.random.key(1), len(jm.unit_names()))
    tok = tokens(tm.cfg, 2, 24, 0)
    jst = {"batch": {"tokens": jnp.asarray(tok, jnp.int32)}}
    tst = {"batch": {"tokens": torch.as_tensor(tok)}}
    for name, k in zip(jm.unit_names(), keys):
        jp = jm.init_unit(name, k)
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        jst = jm.unit_apply(name, jp, jst)
        tst = tm.unit_apply(name, tp, tst)
        out = "logits" if name == "final" else "x"
        close(tst[out], jst[out])


def test_forward_matches(dense_pair):
    jm, jparams, tm, tparams = dense_pair
    tok = tokens(tm.cfg, 2, 33, 1)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    tl, aux = tm.forward(tparams, {"tokens": torch.as_tensor(tok)})
    assert tuple(tl.shape) == (2, 33, tm.cfg.vocab_size)
    close(tl, jl)
    assert float(aux) == 0.0


def test_prefill_and_decode_match(dense_pair):
    jm, jparams, tm, tparams = dense_pair
    B, S, L = 2, 20, 40
    tok = tokens(tm.cfg, B, S, 2)
    jc = jm.init_cache(B, L)
    tc = tm.init_cache(B, L)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok, jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(tok)}, tc)
    close(tl, jl)
    close(tc["s0"]["k"], jc["s0"]["k"])
    nxt = np.array(jnp.argmax(jl[:, -1], -1))
    for t in range(S, S + 6):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt[:, None],
                                                          jnp.int32),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.as_tensor(nxt[:, None]),
                                torch.as_tensor(pos))
        close(tl, jl)
        nxt = np.array(jnp.argmax(jl[:, -1], -1))
    close(tc["s0"]["v"], jc["s0"]["v"])


@pytest.mark.parametrize("S,n_new", [(5, 12), (17, 8)])
def test_greedy_generation_tokens_equal(pair, S, n_new):
    jm, jparams, tm, tparams = pair
    prompt = tokens(tm.cfg, 1, S, S)[0]
    want = jgenerate(jm, jparams, prompt, n_new=n_new, cache_len=64)
    got = tgenerate(tm, tparams, prompt, n_new=n_new, cache_len=64,
                    device="cpu")
    assert got == want


def test_sampling_is_per_row_deterministic(pair):
    _, _, tm, tparams = pair
    prompt = tokens(tm.cfg, 1, 9, 4)[0]
    kw = dict(n_new=10, cache_len=32, temperature=0.8, device="cpu")
    a = tgenerate(tm, tparams, prompt, seed=5, **kw)
    assert a == tgenerate(tm, tparams, prompt, seed=5, **kw)
    assert a != tgenerate(tm, tparams, prompt, seed=6, **kw)


def test_params_from_numpy_checks_structure(pair):
    jm, jparams, tm, _ = pair
    tree = jax.tree.map(np.asarray, jparams)
    del tree["final"]["head"]
    with pytest.raises(ValueError, match="does not match"):
        ttransformer.params_from_numpy(tm.cfg, tree, device="cpu")
