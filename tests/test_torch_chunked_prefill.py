"""The port's chunked prefill (``LM.prefill_chunked``) against its own
unchunked ``prefill`` and against the JAX package's ``prefill_chunked``,
the three cases of ``tests/test_chunked_prefill.py`` on the port: chunked
equals unchunked (yi-9b, arctic-480b and internvl2-76b smoke, f32, no
window, B 2, S 32, chunk 8); a cache built chunk by chunk decodes as a
full forward does; and the refusals (SSM, encoder, hybrid, a window, a
prompt the chunk does not divide, a cache shorter than the prompt).  The
JAX side runs with ``REPRO_PALLAS=ref``; port and JAX share weights
through ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro_torch import tree as tree_util
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)            # test_torch_model.py's
CHUNK_TOL = dict(atol=2e-4, rtol=1e-3)      # test_chunked_prefill.py's
STEP_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def make_pair(arch, **replace):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32, **replace)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32, **replace)
    jm = jtransformer.LM(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


def cache_leaves(tree, port: bool):
    """{path: array} of a cache tree, JAX's or the port's."""
    if port:
        return {"/".join(p): leaf.numpy()
                for p, leaf in tree_util.leaves_with_path(tree)}
    return {"/".join(str(k.key) for k in p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def prompt(cfg, B, S, seed):
    """(JAX batch, port batch): tokens, and for the VLM 8 image rows ahead
    of S - 8 tokens."""
    r = np.random.default_rng(seed)
    if cfg.family.value == "vlm":
        n_img = 8
        tok = r.integers(0, cfg.vocab_size, (B, S - n_img))
        img = r.standard_normal((B, n_img, cfg.frontend_dim)).astype(
            np.float32)
        return ({"tokens": jnp.asarray(tok, jnp.int32),
                 "img": jnp.asarray(img)},
                {"tokens": torch.as_tensor(tok),
                 "img": torch.as_tensor(img)})
    tok = r.integers(0, cfg.vocab_size, (B, S))
    return ({"tokens": jnp.asarray(tok, jnp.int32)},
            {"tokens": torch.as_tensor(tok)})


@pytest.mark.parametrize("arch", ["yi-9b", "arctic-480b", "internvl2-76b"])
def test_chunked_matches_unchunked(arch):
    jm, jparams, tm, tparams = make_pair(arch, sliding_window=0)
    B, S = 2, 32
    jb, tb = prompt(tm.cfg, B, S, 1)
    lg1, c1 = tm.prefill(tparams, tb, tm.init_cache(B, S))
    lg2, c2 = tm.prefill_chunked(tparams, tb, tm.init_cache(B, S), chunk=8)
    assert lg2.shape == (B, 8, tm.cfg.vocab_size)
    close(lg1[:, -1], lg2[:, -1], CHUNK_TOL)
    l1, l2 = cache_leaves(c1, True), cache_leaves(c2, True)
    assert sorted(l1) == sorted(l2)
    for path in l1:
        close(l1[path], l2[path], CHUNK_TOL)
    # the reference's chunked prefill on the same weights and inputs
    jlg, jc = jm.prefill_chunked(jparams, jb, jm.init_cache(B, S), chunk=8)
    close(lg2, jlg, TOL)
    jl = cache_leaves(jc, False)
    assert sorted(jl) == sorted(l2)
    for path in jl:
        close(l2[path], jl[path], TOL)


def test_chunked_then_decode():
    """A cache built by chunked prefill decodes as the full forward."""
    jm, jparams, tm, tparams = make_pair("yi-9b")
    B, S, Sp = 2, 24, 16
    tok = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, (B, S))
    full, _ = tm.forward(tparams, {"tokens": torch.as_tensor(tok)})
    cache = tm.init_cache(B, 32)
    lg, cache = tm.prefill_chunked(
        tparams, {"tokens": torch.as_tensor(tok[:, :Sp])}, cache, chunk=8)
    jtok = jnp.asarray(tok, jnp.int32)
    jlg, jcache = jm.prefill_chunked(jparams, {"tokens": jtok[:, :Sp]},
                                     jm.init_cache(B, 32), chunk=8)
    close(lg, jlg, TOL)
    for t in range(Sp, S):
        lg, cache = tm.decode_step(
            tparams, cache, torch.as_tensor(tok[:, t:t + 1]),
            torch.full((B,), t, dtype=torch.int32))
        jlg, jcache = jm.decode_step(jparams, jcache, jtok[:, t:t + 1],
                                     jnp.full((B,), t, jnp.int32))
        close(lg[:, 0], full[:, t], STEP_TOL)
        close(lg, jlg, TOL)


# (arch, S, cache_len, chunk, what the reference raises)
REFUSED = {
    "ssm": ("mamba2-780m", 16, 16, 8, AssertionError),
    "encoder": ("hubert-xlarge", 16, 16, 8, AssertionError),
    "hybrid": ("recurrentgemma-2b", 16, 16, 8, AssertionError),
    "window": ("h2o-danube-3-4b", 16, 16, 8, AssertionError),
    "S % chunk": ("yi-9b", 12, 16, 8, AssertionError),
    # the reference's static slice of the cache prefix fails at trace time
    "short cache": ("yi-9b", 16, 8, 8, TypeError),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_chunked_refuses(case):
    arch, S, cache_len, chunk, ref_error = REFUSED[case]
    jm, jparams, tm, tparams = make_pair(arch)
    cfg = tm.cfg
    if cfg.family.value == "audio":
        fr = np.random.default_rng(3).standard_normal(
            (1, S, cfg.frontend_dim)).astype(np.float32)
        jb = {"frames": jnp.asarray(fr), "tokens": jnp.zeros((1, S),
                                                             jnp.int32)}
        tb = {"frames": torch.as_tensor(fr),
              "tokens": torch.zeros((1, S), dtype=torch.long)}
    else:
        jb, tb = prompt(cfg, 1, S, 3)
    with pytest.raises(ValueError, match="prefill_chunked"):
        tm.prefill_chunked(tparams, tb, tm.init_cache(1, cache_len),
                           chunk=chunk)
    with pytest.raises(ref_error):
        jm.prefill_chunked(jparams, jb, jm.init_cache(1, cache_len),
                           chunk=chunk)
