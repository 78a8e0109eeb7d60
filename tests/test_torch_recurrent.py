"""The port's LM on the two recurrent families against the JAX package's,
from the same weights (``params_from_numpy``), at f32 compute with
``REPRO_PALLAS=ref``: mamba2-780m smoke (3 ``ssd`` layers) and
recurrentgemma-2b smoke (one ``(rglru, rglru, attn)`` unit plus a
two-layer ``rglru`` tail).  Per-unit ``unit_apply``, ``forward``, and
``prefill`` + ``decode_step`` logits within 1e-4; greedy
``reference_generate`` tokens equal; the stacked-plus-tail tree.  And one
bf16 drift witness per family: on the same bf16 weights (a cast at A
makes every leaf bf16, the gates' 1-D leaves too) the port's bf16
forward drifts from the f32 oracle no more than 1.15x the JAX package's
layer-by-layer path (``unit_apply`` per unit, what a cold start's E
runs), so the port rounds the gates (``pxf * wa + ba``, ``-exp(a_log)``,
``dt + dt_bias``) to bf16 nowhere JAX keeps f32.  The reference is the
unit path, not JAX's scanned ``forward``: XLA compiles the scan body
into fused kernels that round bf16 elsewhere, and for these families
that moves JAX's own drift by about as much as the port differs from
its unit path (``pytest -s`` prints all three).  Drift is chaotic at
these widths (a one-ulp change moves it by tens of percent), so a second
witness holds each recurrent block alone: from the JAX unit's bf16
input, the port's bf16 output equals JAX's in at least 99% of its
elements (it is bit-equal but for a few; rounding ``dt + dt_bias`` or
``pxf * wa + ba`` to bf16 changes 8-40% of them)."""
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
from torch_testlib import close

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("mamba2-780m", "recurrentgemma-2b")
GATES = ("a_log", "dt_bias", "d_skip", "wa", "ba", "wi", "bi", "lam")


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def perturb_gates(params, seed=0):
    """The init's zero gates and unit skips hide how they are read: give
    the 1-D recurrent leaves random values."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.5,
                                    v.dtype)
                        if k in GATES else walk(v)) for k, v in tree.items()}
        return tree
    return walk(params)


def models(arch, n_layers=None, dtype="float32"):
    kw = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=getattr(torch, dtype), **kw)
    return jcfg, jtransformer.build(jcfg), tcfg, \
        ttransformer.build(tcfg, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, jm, tcfg, tm = models(request.param)
    jparams = perturb_gates(jm.init(jax.random.key(0)))
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_unit_apply_matches(pair):
    jm, _, tm, _ = pair
    keys = jax.random.split(jax.random.key(1), len(jm.unit_names()))
    tok = tokens(tm.cfg, 2, 24, 0)
    jst = {"batch": {"tokens": jnp.asarray(tok, jnp.int32)}}
    tst = {"batch": {"tokens": torch.as_tensor(tok)}}
    for name, k in zip(jm.unit_names(), keys):
        jp = perturb_gates(jm.init_unit(name, k))
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        jst = jm.unit_apply(name, jp, jst)
        tst = tm.unit_apply(name, tp, tst)
        close(tst["logits" if name == "final" else "x"],
              jst["logits" if name == "final" else "x"], **TOL)


def test_forward_matches(pair):
    jm, jparams, tm, tparams = pair
    tok = tokens(tm.cfg, 2, 33, 1)
    jl, _ = jm.forward(jparams, {"tokens": jnp.asarray(tok, jnp.int32)})
    tl, aux = tm.forward(tparams, {"tokens": torch.as_tensor(tok)})
    assert tuple(tl.shape) == (2, 33, tm.cfg.vocab_size)
    close(tl, jl, **TOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_match(pair):
    jm, jparams, tm, tparams = pair
    tok = tokens(tm.cfg, 2, 20, 2)
    jc = jm.init_cache(2, 32)
    tc = tm.init_cache(2, 32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :16],
                                                         jnp.int32)}, jc)
    tl, tc = tm.prefill(tparams, {"tokens": torch.as_tensor(tok[:, :16])}, tc)
    close(tl, jl, **TOL)
    for s in range(16, 20):
        pos = np.full((2,), s, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok[:, s:s + 1],
                                                         jnp.int32),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.as_tensor(tok[:, s:s + 1]),
                                torch.as_tensor(pos))
        close(tl, jl, **TOL)
    # the caches hold the same states (conv rings, SSD / RG-LRU, K/V)
    for (path, a) in ttransformer.tree_util.leaves_with_path(tc):
        b = jc
        for k in path:
            b = b[k]
        close(a, b, **TOL)


def test_greedy_tokens_equal_jax(pair):
    jm, jparams, tm, tparams = pair
    prompt = tokens(tm.cfg, 1, 9, 3)[0]
    want = jgenerate(jm, jparams, prompt.astype(np.int32), n_new=8,
                     cache_len=32)
    got = tgenerate(tm, tparams, prompt, n_new=8, cache_len=32, device="cpu")
    assert got == list(want)


def test_grouped_tree_and_shape_check():
    _, jm, tcfg, tm = models("recurrentgemma-2b")
    assert (tm.pattern, tm.n_units, tm.tail_kinds) == \
        (("rglru", "rglru", "attn"), 1, ("rglru", "rglru"))
    assert [tm.layer_kind(j) for j in range(5)] == \
        ["rglru", "rglru", "attn", "rglru", "rglru"]
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    params = ttransformer.params_from_numpy(tcfg, tree, device="cpu")
    assert sorted(params["blocks"]) == ["s0", "s1", "s2", "t0", "t1"]
    assert tuple(params["blocks"]["s2"]["attn"]["wq"].shape)[0] == 1
    assert tuple(params["blocks"]["t0"]["rglru"]["lam"].shape) == \
        (tcfg.rglru_width,)
    tree["blocks"]["t1"]["rglru"]["lam"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="does not match"):
        ttransformer.params_from_numpy(tcfg, tree, device="cpu")


def unit_params(jm, params, name):
    """Unit ``name``'s params: its slice of the stacked groups, or its
    tail group."""
    if name in ("embed", "final"):
        return params[name]
    u, j = len(jm.pattern), int(name.split("_")[1])
    if j < jm.n_units * u:
        return jax.tree.map(lambda a: a[j // u], params["blocks"][f"s{j % u}"])
    return params["blocks"][f"t{j - jm.n_units * u}"]


def jax_unit_chain(jm, params, batch):
    """Logits of the JAX package's layer-by-layer path (``unit_apply``
    per unit)."""
    state = {"batch": batch}
    for name in jm.unit_names():
        state = jm.unit_apply(name, unit_params(jm, params, name), state)
    return state["logits"]


def max_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("arch,n_layers", [("mamba2-780m", 8),
                                           ("recurrentgemma-2b", 8)])
def test_bf16_drift_from_f32_no_worse_than_jax(arch, n_layers):
    jcfg, jm, tcfg, tm = models(arch, n_layers)
    jparams = perturb_gates(jm.init(jax.random.key(5)), seed=5)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    jbatch = {"tokens": jnp.asarray(tok, jnp.int32)}
    tbatch = {"tokens": torch.as_tensor(tok)}
    oracle = np.asarray(jm.forward(jparams, jbatch)[0], np.float32)
    # the bf16 weights a cast at A makes, every leaf included
    jbf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    _, jmb, _, tmb = models(arch, n_layers, "bfloat16")
    jbf = jax_unit_chain(jmb, jbf16, jbatch)
    jscan = jmb.forward(jbf16, jbatch)[0]
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jbf16), device="cpu")
    tbf = tmb.forward(tparams, tbatch)[0]
    tparams32 = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    assert max_rel(tm.forward(tparams32, tbatch)[0], oracle) <= 1e-4
    d_jax, d_port = max_rel(jbf, oracle), max_rel(tbf.float(), oracle)
    print(f"{arch} {n_layers} layers: bf16 drift from f32 of max |logit|, "
          f"port {d_port:.3e}, JAX by units {d_jax:.3e}, JAX's scanned "
          f"forward {max_rel(jscan, oracle):.3e}")
    assert 1e-3 < d_jax                        # bf16 really was computed
    assert d_port <= 1.15 * d_jax, (d_port, d_jax)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_recurrent_blocks_round_as_jax(arch):
    jcfg, jm, tcfg, tm = models(arch, 8, "bfloat16")
    jbf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), perturb_gates(
        jm.init(jax.random.key(5)), seed=5))
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, 32))
    state = jm.unit_apply("embed", jbf16["embed"],
                          {"batch": {"tokens": jnp.asarray(tok, jnp.int32)}})
    checked = 0
    for name in jm.unit_names()[1:-1]:
        jp = unit_params(jm, jbf16, name)
        x = state["x"]
        state = jm.unit_apply(name, jp, state)
        kind = jm.layer_kind(int(name.split("_")[1]))
        if kind == "attn":                 # held by the dense witness
            continue
        tp = jax.tree.map(lambda a: torch.from_numpy(
            np.asarray(a, np.float32)).to(torch.bfloat16), jp)
        got = tm.unit_apply(name, tp, {
            "x": torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16),
            "positions": torch.arange(32)[None]})["x"]
        same = float((got.float().numpy() ==
                      np.asarray(state["x"], np.float32)).mean())
        assert same >= 0.99, (name, kind, same)
        checked += 1
    assert checked == (8 if arch.startswith("mamba") else 6)
