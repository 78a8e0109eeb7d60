"""The port's chunked prefill (``LM.prefill_chunked``) against its own
unchunked ``prefill`` and against the JAX package's ``prefill_chunked``,
the three cases of ``tests/test_chunked_prefill.py`` on the port: chunked
equals unchunked (yi-9b, arctic-480b and internvl2-76b smoke, f32, no
window, B 2, S 32, chunk 8); a cache built chunk by chunk decodes as a
full forward does; and the refusals (SSM, encoder, hybrid, a window, a
prompt the chunk does not divide, a cache shorter than the prompt).  Then
the MoE case that drops tokens (arctic smoke at capacity factor 1.0: the
capacity is per chunk), against JAX's, and the keep pattern that
``chip_smoke.py`` phase 32 compares chunked and unchunked runs by, against
a direct count and against ``moe_block``'s output.  The JAX side runs with
``REPRO_PALLAS=ref``; port and JAX share weights through
``params_from_numpy``."""
import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro_torch import tree as tree_util
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from torch_testlib import ROOT

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


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chunked_moe_with_capacity_drops_matches_jax():
    """arctic-480b smoke at capacity factor 1.0, B 2, S 32, chunk 8: the
    capacity is per call (C 2 a chunk of 8, 8 for the prompt), and a chunk
    drops tokens (the smoke's ``keep_pattern`` over each router call's
    weights, recorded by ``route_spy``); the port's ``prefill_chunked``
    equals the JAX package's, logits and every cache leaf within TOL."""
    jm, jparams, tm, tparams = make_pair("arctic-480b", capacity_factor=1.0)
    cfg, cs = tm.cfg, chip_smoke()
    B, S = 2, 32
    jb, tb = prompt(cfg, B, S, 4)
    assert (tmoe.capacity(cfg, 8), tmoe.capacity(cfg, S)) == (2, 8)
    with cs.route_spy() as spy:
        lg, c = tm.prefill_chunked(tparams, tb, tm.init_cache(B, S), chunk=8)
    assert len(spy.weights) == cfg.n_layers * S // 8
    drops = [cs.dropped_tokens(w, cs.keep_pattern(cfg, w))
             for w in spy.weights]
    assert max(drops) > 0, drops
    jlg, jc = jm.prefill_chunked(jparams, jb, jm.init_cache(B, S), chunk=8)
    close(lg, jlg, TOL)
    tl, jl = cache_leaves(c, True), cache_leaves(jc, False)
    assert sorted(tl) == sorted(jl)
    for path in jl:
        close(tl[path], jl[path], TOL)


def test_keep_pattern_matches_a_direct_count():
    """``chip_smoke.keep_pattern`` on one router call's weights against a
    direct count: per (row, expert) the tokens in order of weight, the
    lower index first among equal weights (rows repeated so that weights
    tie), the first C kept where the weight is not 0; ``dropped_tokens``
    counts the tokens with a chosen expert not kept; and ``moe_block``'s
    output is the kept experts' weighted outputs plus the dense residual,
    token by token."""
    _, _, tm, tparams = make_pair("arctic-480b", capacity_factor=1.0)
    cfg, cs = tm.cfg, chip_smoke()
    p = next(tm._layers(tparams["blocks"]))[1]["moe"]
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    x[:, 12:] = x[:, :12]                      # every weight ties once
    w_te, _, _ = tmoe.route(cfg, p["router"], x)
    kept = cs.keep_pattern(cfg, w_te)
    B, S, E = w_te.shape
    C = tmoe.capacity(cfg, S)
    w = w_te.numpy()
    want = np.zeros((B, S, E), bool)
    for b in range(B):
        for e in range(E):
            order = sorted(range(S), key=lambda t: (-w[b, t, e], t))
            for t in order[:C]:
                want[b, t, e] = w[b, t, e] > 0
    np.testing.assert_array_equal(kept.numpy(), want)
    chosen = w > 0
    assert cs.dropped_tokens(w_te, kept) == int(
        (chosen & ~want).any(-1).sum()) > 0
    y, _ = tmoe.moe_block(cfg, p, x, with_aux=False)
    ex = p["experts"]
    h = torch.einsum("bsd,edf->bsef", x, ex["wg"])
    u = torch.einsum("bsd,edf->bsef", x, ex["wu"])
    ye = torch.einsum("bsef,efd->bsed", torch.nn.functional.silu(h) * u,
                      ex["wd"])
    direct = torch.einsum("bse,bsed->bsd", w_te * kept, ye)
    direct = direct + tlayers.mlp_block(cfg, p["dense"], x)
    torch.testing.assert_close(y, direct, rtol=1e-5, atol=1e-5)


def test_prefix_reuse_equals_the_same_split_through_the_slotted_model():
    """MoE capacity is per call, so a paged request that reuses prefix
    pages and prefills only its suffix may keep other tokens than a whole
    prompt's prefill: arctic-480b smoke (one layer, capacity factor 1.0),
    a 64-token prompt served first, then three of its prefixes at once
    reusing its pages; each request's tokens equal ``chip_smoke``'s
    ``segmented_generate`` at the same split (prefill of the reused
    prefix, ``prefill_continue`` of the rest, decode steps), and here two
    of them differ from ``reference_generate``'s whole prefill."""
    from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                     reference_generate)
    cs = chip_smoke()
    cfg = dataclasses.replace(tget_config("arctic-480b", smoke=True),
                              compute_dtype=torch.float32,
                              capacity_factor=1.0, n_layers=1)
    tm = ttransformer.build(cfg, device="cpu")
    params = tm.init(3)
    base = np.random.default_rng(5).integers(0, cfg.vocab_size, (64,))
    prompts = [base[:n] for n in (23, 40, 50)]
    sched = DecodeScheduler(tm, params, n_slots=4, cache_len=128,
                            kv_page_tokens=16)
    lead = sched.generate(GenerateSpec(prompt=base, n_new=16))
    assert lead.tokens == reference_generate(tm, params, base, n_new=16,
                                             cache_len=128, device="cpu")
    rest = cs.run_concurrent(sched, [GenerateSpec(prompt=p, n_new=16)
                                     for p in prompts], {})
    assert sched.stats()["kv_prefix_hits"] == sum(
        (len(p) - 1) // 16 for p in prompts)
    whole = 0
    for p, r in zip(prompts, rest):
        off = (len(p) - 1) // 16 * 16
        assert r.tokens == cs.segmented_generate(tm, params, p, off, 16,
                                                 cache_len=128)
        whole += r.tokens == reference_generate(tm, params, p, n_new=16,
                                                cache_len=128, device="cpu")
    assert whole == 1


def test_prefix_reuse_matches_the_jax_scheduler_past_capacity_drops():
    """The same case through both packages' paged schedulers: arctic-480b
    smoke at one layer and capacity factor 1.0, weights shared through
    ``params_from_numpy``, 16-token pages, a 64-token prompt served
    first, then three of its prefixes each reusing its pages.  The port's
    tokens equal the JAX ``DecodeScheduler``'s request by request (both
    prefill only the suffix past the reused pages, with the capacity of
    that call), the lead's equal ``reference_generate``'s, and some
    prefix request's differ from the whole prompt's
    ``reference_generate``: a capacity drop the suffix-only prefill does
    not make, in the reference as in the port."""
    from repro.serving import DecodeScheduler as JScheduler
    from repro.serving import GenerateSpec as JSpec
    from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                     reference_generate)
    jm, jparams, tm, tparams = make_pair("arctic-480b", capacity_factor=1.0,
                                         n_layers=1)
    cfg, cs = tm.cfg, chip_smoke()
    base = np.random.default_rng(5).integers(0, cfg.vocab_size, (64,))
    prompts = [base[:n] for n in (23, 40, 50)]
    jsched = JScheduler(jm, jparams, n_slots=4, cache_len=128,
                        kv_page_tokens=16)
    want = [jsched.generate(JSpec(prompt=p.astype(np.int32), n_new=16)).tokens
            for p in [base] + prompts]
    hits = sum((len(p) - 1) // 16 for p in prompts)
    assert jsched.stats()["kv_prefix_hits"] == hits
    sched = DecodeScheduler(tm, tparams, n_slots=4, cache_len=128,
                            kv_page_tokens=16)
    lead = sched.generate(GenerateSpec(prompt=base, n_new=16))
    rest = cs.run_concurrent(sched, [GenerateSpec(prompt=p, n_new=16)
                                     for p in prompts], {})
    assert sched.stats()["kv_prefix_hits"] == hits
    assert [r.tokens for r in [lead] + rest] == [list(w) for w in want]
    whole = [reference_generate(tm, tparams, p, n_new=16, cache_len=128,
                                device="cpu") for p in [base] + prompts]
    assert lead.tokens == whole[0]
    assert any(r.tokens != w for r, w in zip(rest, whole[1:]))


def test_a_chunked_cache_is_its_rows_projection():
    """``chip_smoke.kv_by_rows``, phase 32's account of arctic's chunked
    cache: one layer of arctic-480b smoke (f32, capacity factor 1.0), S 32,
    chunk 8; each cache equals bit for bit the K and V that
    ``qkv_project`` gives its rows (the prompt's at once, unchunked; each
    chunk's alone, chunked), the normed rows agree, and the products by
    row count are read; a cache with one value changed is not rebuilt."""
    _, _, tm, tparams = make_pair("arctic-480b", capacity_factor=1.0,
                                  n_layers=1)
    cs = chip_smoke()
    _, tb = prompt(tm.cfg, 1, 32, 6)
    cu, cc = tm.init_cache(1, 32), tm.init_cache(1, 32)
    tm.prefill(tparams, tb, cu)
    tm.prefill_chunked(tparams, tb, cc, chunk=8)
    rebuilt, normed, products = cs.kv_by_rows(tm, tparams, tb, cu, cc,
                                              chunk=8)
    assert rebuilt and normed
    assert len(products) == 4 and all(d >= 0 for d in products)
    (_, layer), = tm._layers(cc)
    layer["v"][0, 0, 20, 0] += 1.0
    assert not cs.kv_by_rows(tm, tparams, tb, cu, cc, chunk=8)[0]
