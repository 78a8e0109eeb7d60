"""The MoE configs of ``chip_smoke.py`` phase 32 (mixtral-8x7b at 32
layers, one arctic-480b layer) on the CPU, at their smoke variants in f32:
the unit-at-a-time deploy (``deploy_model``'s lazy draw, and the smoke's
``card_units`` generator) writes a manifest and ``.bin`` files byte for
byte the dict deploy's, int8; cicada cold starts from a JAX-deployed int8
store, dequantized at A and int8-resident (``compute_quant``), match the
JAX engine's logits within 1e-4; greedy tokens equal the JAX package's
``reference_generate`` (mixtral's smoke past its 16-token window: a
40-token prompt and 24 new tokens), and the slotted and paged schedulers'
tokens on the int8-resident params equal ``reference_generate``'s; the
launches a forward, a prefill and a step (slotted and paged) make are
phase 20's formula, ``lm_counts`` plus ``quant_products``, which
``kernel_counts`` now gives for every MoE config; and the smoke's streamed
oracle (``streamed_logits``: a unit at a time from the int8-resident
params) gives the f32-at-A load's logits.  The JAX side runs with
``REPRO_PALLAS=ref``."""
import dataclasses
import importlib.util
import types

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
from repro_torch.core import ColdStartEngine as TEngine
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import Family
from repro_torch.models.api import get_config as tget_config
from repro_torch.models.api import list_archs
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 reference_generate)
from repro_torch.store import store as tstore
from torch_testlib import COLDSTART_TOL as TOL
from torch_testlib import ROOT

torch.set_num_threads(2)
ARCHS = ["mixtral-8x7b", "arctic-480b"]
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
    """The lazy draw, the smoke's ``card_units`` on a CPU model and a dict
    of the same units deploy identical int8 manifests and ``.bin`` files
    (the 3-D expert leaves quantized over their last axis), and the
    smoke's disk estimate ``int8_store_bytes`` bounds the store's bytes
    within 63 a leaf."""
    m = port_model(arch)
    units = {n: m.init_unit(n, torch.Generator().manual_seed(
        ttransformer.unit_seed(3, i))) for i, n in enumerate(m.unit_names())}
    cs = chip_smoke()
    sources = {"dict": units, "lazy": None,
               "card_units": cs.card_units(m, seed=3)}
    got = {}
    for label, src in sources.items():
        st = tstore.WeightStore(str(tmp_path / label))
        tstore.deploy_model(st, m, "m", seed=3, quant="int8",
                            params_by_unit=src)
        got[label] = store_bytes(tmp_path / label, "m")
    assert set(got["dict"]) == {"manifest.json"} | {
        f"{n}.bin" for n in m.unit_names()}
    assert got["lazy"] == got["dict"]
    assert got["card_units"] == got["dict"]
    nbytes = st.model_nbytes("m")
    n_leaves = sum(len(u["extents"])
                   for u in st.manifest("m")["units"].values())
    assert nbytes <= cs.int8_store_bytes(m) <= nbytes + 63 * n_leaves


# ---------------------------------------------------------------------------
# cold starts, tokens and launches against the JAX package and phase 32
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
    """Greedy tokens on the dequantized and the int8-resident params equal
    the JAX package's ``reference_generate`` on its own (mixtral: also
    past its window, the ring wrapping); the slotted and paged schedulers
    on the int8-resident params equal the port's ``reference_generate``
    there."""
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


def test_launches_are_lm_counts_and_quant_products(setup, monkeypatch):
    """Spies on the registry's wrappers: a bf16-at-A load transforms every
    leaf; per forward, prefill and decode step, slotted and paged, on the
    bf16 and the int8-resident params, the launches equal
    ``chip_smoke.kernel_counts``, which is ``lm_counts`` plus
    ``quant_products`` (mixtral's windowed layers keep their rings
    slot-resident, arctic's page)."""
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
    per_fwd, per_step = cs.lm_counts(cfg)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (19,))
    for label, params in loads.items():
        quant = label == "int8"
        products = {"quant_matmul": cs.quant_products(cfg) if quant else 0}
        fwd, step = cs.kernel_counts(cfg, quant=quant)
        assert {**fwd, **products} == {**per_fwd, **products, **(
            {"weight_transform": 0} if quant else {})}
        got = counted(lambda: tm.forward(params, setup.batch))
        assert got == {**dict.fromkeys(KERNELS, 0), **per_fwd,
                       **products}, label
        for pages in (None, 16):
            fwd, step = cs.kernel_counts(cfg, quant=quant,
                                         paged=pages is not None)
            paged = pages is not None and not cfg.sliding_window
            assert step.get("decode_attention_paged", 0) == (
                cfg.n_layers if paged else 0)
            sched = DecodeScheduler(tm, params, n_slots=2, cache_len=64,
                                    kv_page_tokens=pages)
            got = counted(lambda: sched.generate(GenerateSpec(
                prompt=prompt, n_new=6)))
            steps = sched.stats()["steps"]
            assert steps == 5
            assert got == {**dict.fromkeys(KERNELS, 0), **{
                k: fwd.get(k, 0) + steps * step.get(k, 0)
                for k in set(fwd) | set(step)}}, (label, pages)


def test_streamed_oracle_equals_the_f32_at_a_load(setup):
    """``chip_smoke.streamed_logits`` over the int8-resident params, a unit
    at a time: its f32 logits equal the f32-at-A load's of the same store
    bit for bit, and its bf16 logits the bf16-at-A load's (a bf16-compute
    model); ``check_streamed`` passes on the same store."""
    cs = chip_smoke()
    tm = setup.tm
    quant = tload(setup, compute_quant=True).params
    got = cs.streamed_logits(tm, quant, setup.batch)
    torch.testing.assert_close(got[torch.float32], tload(setup).logits,
                               rtol=0, atol=0)
    m16 = ttransformer.build(dataclasses.replace(
        tm.cfg, compute_dtype=torch.bfloat16), device="cpu")
    want16 = TEngine(m16, "q", setup.store, strategy="cicada",
                     apply_dtype=torch.bfloat16, device="cpu").load(
                         setup.batch).logits
    torch.testing.assert_close(got[torch.bfloat16], want16, rtol=0, atol=0)


def test_teacher_forced_blocks_hold_the_int8_path_and_catch_a_fault(
        setup, monkeypatch):
    """``streamed_logits(..., forced=...)`` on a bf16-compute model's
    int8-resident params gives one reading a block: each block's bf16
    unit and int8-resident unit applied to the f32 forward's input of that
    block, against its f32 output, at the tokens whose kept experts all
    three share; ``hold_layers`` passes on them.  With every
    ``quant_matmul`` product 1% off (a fault of the int8 path: the f32 and
    bf16 units are dequantized from the same params, so a fault in the
    params themselves is not this check's to see), it fails."""
    cs = chip_smoke()
    m16 = ttransformer.build(dataclasses.replace(
        setup.tm.cfg, compute_dtype=torch.bfloat16), device="cpu")
    tok = np.random.default_rng(3).integers(0, m16.cfg.vocab_size, (1, 64))
    batch = {"tokens": torch.as_tensor(tok)}
    quant = TEngine(m16, "q", setup.store, strategy="cicada",
                    compute_quant=True, device="cpu").load(batch).params
    forced = []
    logits = cs.streamed_logits(m16, quant, batch, forced=forced)
    assert [r["block"] for r in forced] == [
        n for n in m16.unit_names() if n.startswith("block_")]
    assert logits[torch.float32].shape == (1, 64, m16.cfg.vocab_size)
    cs.hold_layers("int8-resident", forced)
    real = ops.quant_matmul
    monkeypatch.setattr(ops, "quant_matmul",
                        lambda *a, **kw: real(*a, **kw) * 1.01)
    faulty = []
    cs.streamed_logits(m16, quant, batch, forced=faulty)
    with pytest.raises(cs.Failure):
        cs.hold_layers("int8-resident, its products 1% off", faulty)


def test_kernel_counts_is_phase_20s_formula_for_every_moe_config():
    """For every MoE config of ``list_archs()``, full and smoke, at its
    depth and at one layer: ``kernel_counts`` equals ``lm_counts`` plus
    ``quant_products`` (897 ``quant_matmul`` a forward for mixtral-8x7b at
    32 layers, 392 for one arctic-480b layer), and a paged step pages
    exactly the layers without a window."""
    cs = chip_smoke()
    seen = 0
    for arch in list_archs():
        for smoke in (False, True):
            cfg = tget_config(arch, smoke=smoke)
            if cfg.family != Family.MOE:
                continue
            for layers in (cfg.n_layers, 1):
                c = dataclasses.replace(cfg, n_layers=layers)
                per_fwd, per_step = cs.lm_counts(c)
                extra = {"quant_matmul": cs.quant_products(c),
                         "weight_transform": 0}
                fwd, step = cs.kernel_counts(c, quant=True)
                assert fwd == {**per_fwd, **extra}
                assert step == {**per_step, **extra}
                _, paged = cs.kernel_counts(c, quant=True, paged=True)
                ring = layers if c.sliding_window else 0
                assert paged["decode_attention"] == ring
                assert paged["decode_attention_paged"] == layers - ring
                seen += 1
    assert seen == 8
    full = {a: tget_config(a) for a in ARCHS}
    assert cs.quant_products(full["mixtral-8x7b"]) == 897
    assert cs.quant_products(dataclasses.replace(full["arctic-480b"],
                                                 n_layers=1)) == 392


def test_a_load_lets_go_of_each_units_host_leaves_once_applied(
        setup, monkeypatch):
    """The decoupler drops its hold on a unit's retrieved leaves when the
    weight unit checks the unit in (the host's bytes of a 46.7 GB
    mixtral load are then the units in flight, not the model's): every
    unit is checked in once, after it was applied, with its ``ready``
    entry still there and empty; the load's logits are unchanged."""
    from repro_torch.core import decoupler
    real = decoupler.WeightDecoupler.checkin
    seen = []

    def checkin(self, unit):
        assert self.ready[unit] is not None
        real(self, unit)
        assert unit in self.ready and self.ready[unit] is None
        seen.append(unit)
    monkeypatch.setattr(decoupler.WeightDecoupler, "checkin", checkin)
    res = tload(setup, compute_quant=True)
    assert sorted(seen) == sorted(setup.tm.unit_names())
    np.testing.assert_allclose(res.logits.numpy(),
                               np.asarray(setup.quant.logits), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_assemble_consumes_the_units_it_stacks(arch):
    """``LM.assemble(units, consume=True)`` (what a cold start runs) gives
    the stacked tree ``assemble`` gives, plain leaves and int8-resident
    ``QuantLeaf``s alike, while each unit's leaves leave its tree (so the
    stacked params never sit beside a second copy); a lone unit stacks as
    a view of its leaves."""
    from repro_torch import tree as tree_util
    from repro_torch.quant import QuantLeaf

    def units(m):
        out = {}
        for i, n in enumerate(m.unit_names()):
            gen = torch.Generator().manual_seed(i)
            tree = m.init_unit(n, gen)
            out[n] = tree_util.unflatten(tree, {
                p: (QuantLeaf(leaf.mul(40).round().to(torch.int8),
                              torch.rand(leaf.shape[-1], generator=gen))
                    if leaf.dim() >= 2 else leaf)
                for p, leaf in ((("/".join(k)), v) for k, v in
                                tree_util.leaves_with_path(tree))})
        return out

    for layers in (3, 1):
        m = ttransformer.build(dataclasses.replace(
            tget_config(arch, smoke=True), n_layers=layers), device="cpu")
        want = m.assemble(units(m))
        spent = units(m)
        blocks = [spent[n] for n in m.unit_names()
                  if n.startswith("block_")]
        ptrs = [leaf.q.data_ptr() for _, leaf in
                tree_util.leaves_with_path(blocks[0])
                if isinstance(leaf, QuantLeaf)]
        got = m.assemble(spent, consume=True)
        for (path, a), (_, b) in zip(tree_util.leaves_with_path(want),
                                     tree_util.leaves_with_path(got)):
            assert type(a) is type(b), path
            for x, y in ((a.q, b.q), (a.scale, b.scale)) if isinstance(
                    a, QuantLeaf) else ((a, b),):
                assert torch.equal(x, y), path
        assert all(v is None for b in blocks for v in b.values())
        if layers == 1:
            assert [leaf.q.data_ptr() for _, leaf in
                    tree_util.leaves_with_path(got["blocks"]["s0"])
                    if isinstance(leaf, QuantLeaf)] == ptrs
