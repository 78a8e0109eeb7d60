"""The port's vision family (``repro_torch.models.vision``) held against
the JAX package's (``repro.models.vision``) on the CPU, inputs from a
numpy seed, the JAX side under ``REPRO_PALLAS=ref``.

Tolerances: max pool is bit-exact (a max of the same values); BN and the
conv/dense primitives, whose op order in XLA and PyTorch may differ,
agree within 1e-5 of the output's max magnitude; each unit within 1e-5
of its output's max magnitude; whole forwards within 1e-4 of max |logit|
with top-1 equal.  The sites where XLA's ``SAME`` padding is asymmetric
(stride-2 stem, stride-2 3x3 convs, the -inf max pool) and VGG's NHWC
flatten are named in their own tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import vision as jvision
from repro.models.api import get_config as jget_config
from repro.models.api import list_archs as jlist_archs
from repro_torch import tree as tree_util
from repro_torch.core import ColdStartEngine
from repro_torch.configs.vision_archs import PAPER_MODELS
from repro_torch.models import transformer, vision
from repro_torch.models.api import get_config, list_archs
from repro_torch.store.store import WeightStore

torch.set_num_threads(2)

PRIM_TOL = 1e-5       # of the output's max magnitude
UNIT_TOL = 1e-5       # of the unit output's max magnitude
LOGIT_TOL = 1e-4      # of max |logit|
FAMILIES = ["resnet50", "vgg16", "vit_b_16"]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_configs_name_the_same_models():
    assert list_archs() == jlist_archs()
    for name in PAPER_MODELS:
        for smoke in (False, True):
            j, p = jget_config(name, smoke=smoke), get_config(name,
                                                              smoke=smoke)
            for f in dataclasses.fields(j):
                a, b = getattr(j, f.name), getattr(p, f.name)
                if f.name in ("param_dtype", "compute_dtype"):
                    assert jnp.dtype(a).name == str(b).split(".")[-1]
                elif f.name == "family":
                    assert a.value == b.value == "vision"
                else:
                    assert a == b, (name, f.name)


def test_same_padding_is_xlas_asymmetric_split():
    # the three asymmetric sites at 224 (stem, a stage's first stride-2
    # 3x3 conv, the stem's max pool) and the same at the smoke size
    assert vision.same_pads(224, 7, 2) == (2, 3)
    assert vision.same_pads(56, 3, 2) == (0, 1)
    assert vision.same_pads(112, 3, 2) == (0, 1)
    assert vision.same_pads(32, 7, 2) == (2, 3)
    assert vision.same_pads(16, 3, 2) == (0, 1)
    assert vision.same_pads(8, 3, 1) == (1, 1)
    assert vision.same_pads(7, 2, 2) == (0, 1)
    assert vision.same_pads(14, 16, 16) == (1, 1)
    for size in range(1, 40):
        for k in (1, 2, 3, 7):
            for s in (1, 2):
                lo, hi = vision.same_pads(size, k, s)
                out = (size + lo + hi - k) // s + 1
                assert out == -(-size // s) and 0 <= hi - lo <= 1


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_same_and_valid_match_xla(stride):
    rng = np.random.default_rng(stride)
    for size in (16, 17, 32, 33):
        for k, cin, cout in ((7, 3, 8), (3, 8, 8), (1, 8, 16)):
            x, w = rand(rng, 2, size, size + 1, cin), rand(rng, k, k, cin,
                                                           cout)
            want = jvision.conv2d(jnp.asarray(x), jnp.asarray(w), stride)
            got = vision.conv2d(t(x), t(w), stride)
            assert rel_err(got, want) <= PRIM_TOL, (size, k, stride)
    # the ViT patch embedding: stride = kernel, VALID
    x, w = rand(rng, 1, 32, 32, 3), rand(rng, 8, 8, 3, 16)
    got = vision.conv2d(t(x), t(w), 8, padding="VALID")
    want = jvision.conv2d(jnp.asarray(x), jnp.asarray(w), 8, "VALID")
    assert got.shape == (1, 4, 4, 16)
    assert rel_err(got, want) <= PRIM_TOL


def test_maxpool_pads_with_minus_inf_bit_exact():
    rng = np.random.default_rng(0)
    for size in (16, 17, 32, 112):
        # all-negative input: a zero pad would win at the borders
        x = rand(rng, 2, size, size, 4) - 10.0
        for window, stride in ((3, 2), (2, 2)):
            got = vision.maxpool(t(x), window, stride)
            want = jvision.maxpool(jnp.asarray(x), window, stride)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert got.max().item() < 0


def test_bn_and_fc_match_reference():
    rng = np.random.default_rng(1)
    c = 16
    p = {"scale": rand(rng, c), "bias": rand(rng, c), "mean": rand(rng, c),
         "var": np.abs(rand(rng, c)) + 0.1}
    x = rand(rng, 2, 5, 5, c)
    want = jvision.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x))
    got = vision.bn_apply({k: t(v) for k, v in p.items()}, t(x))
    assert rel_err(got, want) <= PRIM_TOL
    fc = {"w": rand(rng, 64, 10), "b": rand(rng, 10)}
    x = rand(rng, 3, 64)
    assert rel_err(vision.fc_apply({k: t(v) for k, v in fc.items()}, t(x)),
                   jvision.fc_apply({k: jnp.asarray(v) for k, v in
                                     fc.items()}, jnp.asarray(x))) <= PRIM_TOL


def test_vgg_head_flattens_nhwc():
    """At 64x64 the head sees a 2x2x512 map, so fc1's rows are ordered
    (h, w, c); an NCHW flatten reads other rows."""
    jcfg = dataclasses.replace(jget_config("vgg11", smoke=True), img_res=64)
    tcfg = dataclasses.replace(get_config("vgg11", smoke=True), img_res=64)
    jm, tm = jvision.build(jcfg), vision.build(tcfg, device="cpu")
    head = jax.tree_util.tree_map(np.asarray,
                                  jm.init_unit("head", jax.random.key(0)))
    assert head["fc1"]["w"].shape == (2 * 2 * 512, 4096)
    x = np.abs(rand(np.random.default_rng(2), 2, 2, 2, 512))
    want = np.asarray(jm.unit_apply(
        "head", jax.tree_util.tree_map(jnp.asarray, head),
        {"x": jnp.asarray(x)})["logits"])
    tp = jax.tree_util.tree_map(t, head)
    got = tm.unit_apply("head", tp, {"x": t(x)})["logits"]
    assert rel_err(got, want) <= PRIM_TOL
    nchw = tm.unit_apply("head", tp, {"x": t(x).permute(0, 3, 1, 2)
                                      .reshape(2, 2, 2, 512)})["logits"]
    assert rel_err(nchw, want) > 1e-2


# ---------------------------------------------------------------------------
# every unit, and whole forwards, of the paper trio at smoke size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(arch, JAX model, JAX params, port model, port params, image)."""
    arch = request.param
    jcfg, tcfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jm = jvision.build(jcfg)
    jp = jm.init(jax.random.key(11))
    tm = transformer.build(tcfg, device="cpu")
    tp = transformer.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    image = rand(np.random.default_rng(3), 2, 3, jcfg.img_res, jcfg.img_res)
    return arch, jm, jp, tm, tp, image


def test_every_unit_matches_reference(family):
    """Each unit on the reference's own input state (the JAX activation
    of the unit before), so an error is the unit's and not carried."""
    arch, jm, jp, tm, tp, image = family
    assert isinstance(tm, vision.VisionModel)
    assert tm.unit_names() == jm.unit_names()
    jstate = {"batch": {"image": jnp.asarray(image)}}
    for name in jm.unit_names():
        tstate = {"batch": {"image": t(image)}}
        if "x" in jstate:
            tstate["x"] = t(jstate["x"])
        got = tm.unit_apply(name, tp[name], tstate)
        jstate = jm.unit_apply(name, jp[name], jstate)
        assert rel_err(got["x"], jstate["x"]) <= UNIT_TOL, (arch, name)
    assert rel_err(got["logits"], jstate["logits"]) <= UNIT_TOL


def test_forward_matches_reference(family):
    arch, jm, jp, tm, tp, image = family
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        want, _ = jm.forward(jp, {"image": jnp.asarray(image)})
    got, aux = tm.forward(tp, {"image": t(image)})
    want = np.asarray(want)
    assert got.shape == want.shape == (2, tm.cfg.vocab_size)
    assert bool(torch.isfinite(got).all()) and float(aux) == 0.0
    assert rel_err(got, want) <= LOGIT_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_vision_params_round_trip_structure_and_init_rules():
    """The port's own init: the reference's tree and init rules (He
    normal by fan-in, ViT pos at std 0.02, BN / LN at identity), the
    abstract on the meta device, params_from_numpy refusing a wrong
    shape."""
    cfg = get_config("vit_b_16", smoke=True)
    m = transformer.build(cfg, device="cpu")
    params = m.init(0)
    ab = m.abstract()
    assert all(a.device.type == "meta" for a in tree_util.leaves(ab))
    blk = params["block_00"]
    assert abs(blk["wq"].std().item() - (2.0 / 768) ** 0.5) < 5e-3
    assert abs(blk["wo"].std().item() - (2.0 / 12) ** 0.5) < 5e-2
    assert abs(params["patch"]["pos"].std().item() - 0.02) < 2e-3
    assert abs(params["patch"]["proj"].std().item()
               - (2.0 / (16 * 16 * 3)) ** 0.5) < 5e-3
    assert torch.equal(blk["ln1"]["scale"], torch.ones(768))
    assert torch.equal(m.init(0)["head"]["fc"]["w"], params["head"]["fc"]["w"])
    bad = tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                             params)
    transformer.params_from_numpy(cfg, bad, device="cpu")
    bad["head"]["fc"]["b"] = np.zeros(11, np.float32)
    with pytest.raises(ValueError, match="does not match"):
        transformer.params_from_numpy(cfg, bad, device="cpu")
    spec = m.input_specs("prefill", 0, 4)["image"]
    assert tuple(spec.shape) == (4, 3, 32, 32) and spec.device.type == "meta"


def test_engine_refuses_apply_dtype_and_compute_quant(tmp_path):
    m = transformer.build(get_config("vit_b_32", smoke=True), device="cpu")
    store = WeightStore(str(tmp_path))
    for kw in ({"apply_dtype": torch.bfloat16},
               {"apply_dtype": torch.float32}, {"compute_quant": True}):
        with pytest.raises(NotImplementedError, match="vision"):
            ColdStartEngine(m, "m", store, device="cpu", **kw)
