"""The dense configs of ``chip_smoke.py`` phase 31 (yi-9b, codeqwen1.5-7b,
h2o-danube-3-4b) on the CPU, at their smoke variants in f32: the
unit-at-a-time deploy (``deploy_model``'s lazy draw, and the smoke's
``card_units`` generator) writes a manifest and ``.bin`` files byte for
byte the dict deploy's, f32 and int8, and never holds two units drawn at
once; cicada cold starts from a JAX-deployed int8 store, dequantized at A
and int8-resident (``compute_quant``), match the JAX engine's logits
within 1e-4; greedy tokens equal the JAX package's ``reference_generate``
(h2o-danube's smoke past its 16-token window: a 40-token prompt and 24
new tokens, so the ring wraps more than once), and the slotted and paged
schedulers' tokens on the int8-resident params equal
``reference_generate``'s; the launches a forward, a prefill and a step
(slotted and paged) make are phase 31's formula, ``kernel_counts``,
counted with spies on the registry's wrappers.  The JAX side runs with
``REPRO_PALLAS=ref``."""
import dataclasses
import gc
import importlib.util
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.serving.decode import reference_generate as jgenerate
from repro.store import store as jstore
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from repro_torch.store import store as tstore
from torch_testlib import COLDSTART_TOL as TOL
from torch_testlib import ROOT

torch.set_num_threads(2)
ARCHS = ["yi-9b", "codeqwen1.5-7b", "h2o-danube-3-4b"]
KERNELS = ("flash_attention", "decode_attention", "decode_attention_paged",
           "quant_matmul", "weight_transform", "rmsnorm")


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_model(arch):
    return ttransformer.build(dataclasses.replace(
        tget_config(arch, smoke=True), compute_dtype=torch.float32),
        device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request, tmp_path_factory):
    """``arch``'s smoke int8 store deployed by the JAX package, and the
    JAX engine's loads of it (dequantized at A, and int8-resident)."""
    arch = request.param
    root = str(tmp_path_factory.mktemp(arch))
    jm = jtransformer.build(dataclasses.replace(
        jget_config(arch, smoke=True), compute_dtype=jnp.float32))
    js = jstore.WeightStore(root)
    jstore.deploy_model(js, jm, "q", jax.random.key(7), quant="int8")
    tok = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (1, 16))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        jb = {"tokens": jnp.asarray(tok, jnp.int32)}
        deq = JEngine(jm, "q", js, strategy="cicada").load(jb)
        quant = JEngine(jm, "q", js, strategy="cicada",
                        compute_quant=True).load(jb)
    return types.SimpleNamespace(
        jm=jm, tm=port_model(arch), store=tstore.WeightStore(root),
        batch={"tokens": torch.as_tensor(tok)}, deq=deq, quant=quant)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def tload(s, **kw):
    return TEngine(s.tm, "q", s.store, strategy="cicada", chunk_bytes=1 << 14,
                   device="cpu", **kw).load(s.batch)


def store_bytes(root, name):
    d = root / name
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ---------------------------------------------------------------------------
# the unit-at-a-time deploy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lazy_deploy_writes_the_dict_deploys_bytes(tmp_path, arch):
    """The lazy draw, the smoke's ``card_units`` on a CPU model (its
    generator on the model's device, seeded alike) and a dict of the same
    units deploy identical manifests and ``.bin`` files, f32 and int8."""
    m = port_model(arch)
    units = {n: m.init_unit(n, torch.Generator().manual_seed(
        ttransformer.unit_seed(3, i))) for i, n in enumerate(m.unit_names())}
    cs = chip_smoke()
    for quant in (None, "int8"):
        sources = {"dict": units, "lazy": None,
                   "card_units": cs.card_units(m, seed=3)}
        got = {}
        for label, src in sources.items():
            st = tstore.WeightStore(str(tmp_path / label))
            tstore.deploy_model(st, m, "m", seed=3, quant=quant,
                                params_by_unit=src)
            got[label] = store_bytes(tmp_path / label, "m")
        assert set(got["dict"]) == {"manifest.json"} | {
            f"{n}.bin" for n in m.unit_names()}
        assert got["lazy"] == got["dict"], quant
        assert got["card_units"] == got["dict"], quant


def test_lazy_sources_hold_one_unit_at_a_time(tmp_path, monkeypatch):
    """A spy on ``init_unit``: when it draws a unit, no unit it drew before
    is alive, for ``deploy_model``'s own draw and for ``card_units``,
    f32 and int8; the store takes the units in ``unit_names()`` order."""
    m = port_model("yi-9b")
    real = m.init_unit
    drawn, alive_at_draw = [], []

    def spy(name, gen):
        gc.collect()
        alive_at_draw.append(sum(r() is not None for _, r in drawn))
        tree = real(name, gen)
        drawn.append((name, weakref.ref(tree_util.leaves(tree)[0])))
        return tree

    monkeypatch.setattr(m, "init_unit", spy)
    cs = chip_smoke()
    for i, (src, quant) in enumerate([(None, None), (None, "int8"),
                                      ("card_units", None),
                                      ("card_units", "int8")]):
        drawn.clear()
        alive_at_draw.clear()
        st = tstore.WeightStore(str(tmp_path / str(i)))
        tstore.deploy_model(st, m, "m", quant=quant, params_by_unit=(
            cs.card_units(m) if src else None))
        assert [n for n, _ in drawn] == m.unit_names()
        assert list(st.manifest("m")["units"]) == m.unit_names()
        assert alive_at_draw == [0] * len(drawn), (src, quant, alive_at_draw)


# ---------------------------------------------------------------------------
# cold starts, tokens and launches against the JAX package and phase 31
# ---------------------------------------------------------------------------

def test_cold_starts_from_jax_int8_store_match_jax(setup):
    """Dequantized at A (f32) and int8-resident: logits within 1e-4 of the
    JAX engine's on the same store, the warm forward equal to the
    in-pipeline logits."""
    for want, kw in ((setup.deq, {}), (setup.quant, {"compute_quant": True})):
        res = tload(setup, **kw)
        np.testing.assert_allclose(res.logits.numpy(),
                                   np.asarray(want.logits), **TOL)
        warm, _ = setup.tm.forward(res.params, setup.batch)
        torch.testing.assert_close(warm, res.logits, rtol=0, atol=0)


def test_tokens_equal_jax_and_schedulers(setup):
    """Greedy tokens on the dequantized params equal the JAX package's
    ``reference_generate`` on its own (danube: also past its window, the
    ring wrapping); the slotted and paged schedulers on the int8-resident
    params equal ``reference_generate`` there, and the JAX one's on the
    JAX int8-resident params."""
    tm = setup.tm
    rng = np.random.default_rng(5)
    cases = [(rng.integers(0, tm.cfg.vocab_size, (19,)), 8)]
    if tm.cfg.sliding_window:
        W = tm.cfg.sliding_window
        cases.append((rng.integers(0, tm.cfg.vocab_size, (W + 24,)), 24))
        assert len(cases[-1][0]) + cases[-1][1] > 3 * W   # wraps 3 times
    deq = tload(setup).params
    quant = tload(setup, compute_quant=True).params
    for prompt, n_new in cases:
        kw = dict(n_new=n_new, cache_len=64)
        assert reference_generate(tm, deq, prompt, device="cpu", **kw) == \
            jgenerate(setup.jm, setup.deq.params, prompt, **kw)
        want = reference_generate(tm, quant, prompt, device="cpu", **kw)
        assert want == jgenerate(setup.jm, setup.quant.params, prompt, **kw)
        for pages in (None, 16):
            sched = DecodeScheduler(tm, quant, n_slots=2, cache_len=64,
                                    kv_page_tokens=pages)
            assert sched.generate(GenerateSpec(prompt=prompt,
                                               n_new=n_new)).tokens == want
        assert sched.kvpool.stats().pinned == 0


def test_launches_are_phase_31s_formula(setup, monkeypatch):
    """Spies on the registry's wrappers, which the layers and the engine
    call on the CPU as on the card: a bf16-at-A load transforms every
    leaf (the int8 ones and the f32 ones cast); per forward, prefill and
    decode step, slotted and paged, on the bf16 and the int8-resident
    params, the launches equal ``chip_smoke.kernel_counts``."""
    cs = chip_smoke()
    tm, cfg = setup.tm, setup.tm.cfg
    calls = dict.fromkeys(KERNELS, 0)
    for name in KERNELS:
        def spy(*a, _real=getattr(ops, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)

    def counted(fn):
        for k in calls:
            calls[k] = 0
        fn()
        return dict(calls)

    n_q, n_other = cs.leaf_counts(setup.store, "q")
    loads = {}
    got = counted(lambda: loads.update(
        bf16=tload(setup, apply_dtype=torch.bfloat16).params))
    assert got["weight_transform"] == n_q + n_other
    got = counted(lambda: loads.update(
        int8=tload(setup, compute_quant=True).params))
    assert got["weight_transform"] == 0
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (19,))
    for label, params in loads.items():
        quant = label == "int8"
        fwd, step = cs.kernel_counts(cfg, quant=quant)
        got = counted(lambda: tm.forward(params, setup.batch))
        assert got == {**dict.fromkeys(KERNELS, 0), **fwd}, label
        for pages in (None, 16):
            fwd, step = cs.kernel_counts(cfg, quant=quant,
                                         paged=pages is not None)
            sched = DecodeScheduler(tm, params, n_slots=2, cache_len=64,
                                    kv_page_tokens=pages)
            got = counted(lambda: sched.generate(GenerateSpec(
                prompt=prompt, n_new=6)))
            steps = sched.stats()["steps"]
            assert steps == 5
            assert got == {**dict.fromkeys(KERNELS, 0), **{
                k: fwd.get(k, 0) + steps * step.get(k, 0)
                for k in set(fwd) | set(step)}}, (label, pages)
