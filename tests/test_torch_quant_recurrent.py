"""Int8-resident (``compute_quant``) serving of the recurrent families on
the CPU: mamba2-780m and recurrentgemma-2b smoke stores the JAX package
deployed int8, loaded by both engines with ``compute_quant`` (f32 compute,
``REPRO_PALLAS=ref``).  The port's logits are within 1e-4 of the JAX
engine's, its ``QuantLeaf``s are where the reference keeps them, the
params hold about a quarter of the f32 bytes, and greedy tokens from them
equal the JAX scheduler's on the JAX params, slotted and paged.  mamba2's
projections and the tied heads are dequantized at each use through
``weight_transform`` (``quant.dequant``), bit-equal to ``QuantLeaf.astype``;
every other weight product of recurrentgemma goes through ``quant_matmul``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving import DecodeScheduler as JScheduler
from repro.serving import GenerateSpec as JSpec
from repro.store import store as jstore
from repro_torch import quant as tquant
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.kernels import ops
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from torch_testlib import COLDSTART_TOL as TOL
from torch_testlib import coldstart_setup

torch.set_num_threads(2)
ARCHS = ("mamba2-780m", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def qsetups(tmp_path_factory):
    """Per arch: the shared f32/int8 smoke stores, and the JAX engine's
    compute_quant load of the int8 one."""
    out = {}
    for arch in ARCHS:
        setup = coldstart_setup(str(tmp_path_factory.mktemp(arch)), arch=arch)
        tm, ts, batch, _ = setup
        jm = jtransformer.build(dataclasses.replace(
            jget_config(arch, smoke=True), compute_dtype=jnp.float32))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "ref")
            jres = JEngine(jm, "q", jstore.WeightStore(ts.root),
                           strategy="cicada", compute_quant=True).load(
                {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32)})
        out[arch] = (setup, jm, jres)
    return out


def tload(qsetup, strategy, **kw):
    (tm, ts, batch, _), _, _ = qsetup
    return TEngine(tm, "q", ts, strategy=strategy, chunk_bytes=1 << 14,
                   device="cpu", **kw).load(batch)


def _jquant_leaves(params):
    return sorted(jax.tree_util.keystr(p, simple=True, separator="/")
                  for p, leaf in jax.tree_util.tree_flatten_with_path(
                      params, is_leaf=jquant.is_quant)[0]
                  if jquant.is_quant(leaf))


def _tquant_leaves(params):
    return sorted("/".join(p) for p, leaf in tree_util.leaves_with_path(
        params) if tquant.is_quant(leaf))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", ["cicada", "pisel"])
def test_compute_quant_cold_start_matches_jax(qsetups, arch, strategy):
    _, _, jres = qsetups[arch]
    res = tload(qsetups[arch], strategy, compute_quant=True)
    np.testing.assert_allclose(res.logits.numpy(),
                               np.asarray(jres.logits), **TOL)
    got = _tquant_leaves(res.params)
    assert got == _jquant_leaves(jres.params)
    # the 2-D leaves stay int8; the 1-D gates, norms and SSD scalars f32
    assert "embed/tok" in got and all(
        not tquant.is_quant(leaf) and leaf.dtype == torch.float32
        for p, leaf in tree_util.leaves_with_path(res.params)
        if "/".join(p) not in got)
    (tm, _, batch, _), _, _ = qsetups[arch]
    warm, _ = tm.forward(res.params, batch)
    torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_quant_resident_bytes_about_a_quarter(qsetups, arch):
    def nbytes(params):
        return sum(l.nbytes if tquant.is_quant(l)
                   else l.numel() * l.element_size()
                   for l in tree_util.leaves(params))

    qb = nbytes(tload(qsetups[arch], "cicada", compute_quant=True).params)
    fb = nbytes(tload(qsetups[arch], "cicada").params)
    assert 0.25 < qb / fb < 0.3


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_quant_tokens_equal_jax_slotted_and_paged(qsetups, arch):
    """Greedy tokens of the port's slotted and paged schedulers on its
    int8-resident params equal the JAX scheduler's on the JAX
    int8-resident params and the port's ``reference_generate``."""
    (tm, _, _, _), jm, jres = qsetups[arch]
    params = tload(qsetups[arch], "cicada", compute_quant=True).params
    prompt = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (19,))
    want = JScheduler(jm, jres.params, n_slots=2, cache_len=48).generate(
        JSpec(prompt=prompt.astype(np.int32), n_new=6)).tokens
    assert reference_generate(tm, params, prompt, n_new=6, cache_len=48,
                              device="cpu") == want
    for pages in (None, 16):
        sched = DecodeScheduler(tm, params, n_slots=2, cache_len=48,
                                kv_page_tokens=pages)
        assert sched.generate(GenerateSpec(prompt=prompt,
                                           n_new=6)).tokens == want
    assert sched.kvpool.stats().pinned == 0


def test_dequant_at_use_bit_equal_astype():
    """``quant.dequant`` of a QuantLeaf (the stacked leaf's unit view, as
    the layers see it) is ``astype`` bit for bit, in f32 and bf16; a plain
    tensor is cast."""
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (3, 40, 72), generator=g).to(torch.int8)
    s = torch.rand(3, 72, generator=g) * 0.05
    one = tree_util.tree_map(lambda a: a[1], tquant.QuantLeaf(q, s))
    for cd in (torch.float32, torch.bfloat16):
        got = tquant.dequant(one, cd)
        assert got.dtype == cd and got.shape == (40, 72)
        assert torch.equal(got, one.astype(cd))
    w = torch.randn(5, 7, generator=g)
    assert torch.equal(tquant.dequant(w, torch.bfloat16),
                       w.to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_products_take_their_kernels(qsetups, arch, monkeypatch):
    """Per int8-resident forward and decode step: mamba2 dequantizes two
    projections an ssd layer and the tied head through
    ``weight_transform`` and runs no ``quant_matmul``; recurrentgemma runs
    every rglru (wx, wgate, wy), attention (wq, wk, wv, wo) and GeGLU MLP
    (wg, wu, wd) product through ``quant_matmul``, and dequantizes only the
    tied head.  Counted by spying on the registry's wrappers, which the
    layers call on the CPU as on the card."""
    (tm, _, batch, _), _, _ = qsetups[arch]
    params = tload(qsetups[arch], "cicada", compute_quant=True).params
    calls = {"weight_transform": 0, "quant_matmul": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    kinds = tm.cfg.layer_kinds()
    want = {"weight_transform": 2 * kinds.count("ssd") + 1,
            "quant_matmul": 6 * kinds.count("rglru") + 7 * kinds.count(
                "attn")}
    tm.forward(params, batch)
    assert calls == want
    cache = tm.init_cache(2, 32)
    for k in calls:
        calls[k] = 0
    tm.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int64),
                   torch.zeros(2, dtype=torch.int32))
    assert calls == want
