"""Vision cold starts of the port against the JAX package's on the CPU:
stores deployed by the JAX package (f32 and int8), the port's
``ColdStartEngine(device="cpu")`` under all five strategies against the
JAX engine's cicada logits on the same store (JAX under
``REPRO_PALLAS=ref``), within 1e-4 of max |logit|, top-1 equal; the
assembled params' warm forward equals the in-pipeline logits.  Run for
resnet50 smoke and two narrow test-only variants, a 2-layer ViT of width
64 and a VGG of one conv a stage, set on both packages' tables inside the
test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ColdStartEngine as JEngine
from repro.models import transformer as jtransformer
from repro.models import vision as jvision
from repro.models.api import ArchConfig as JConfig
from repro.models.api import Family as JFamily
from repro.models.api import get_config as jget_config
from repro.store import store as jstore
from repro_torch.core import ColdStartEngine
from repro_torch.models import transformer, vision
from repro_torch.models.api import ArchConfig, Family, get_config
from repro_torch.store.store import BandwidthModel, WeightStore

torch.set_num_threads(2)

LOGIT_TOL = 1e-4      # of max |logit|
STRATEGIES = ["traditional", "pisel", "mini", "preload", "cicada"]
# test-only variants: (layers, width, heads, MLP width, patch), and one
# conv in each VGG stage
VIT_T = (2, 64, 4, 128, 8)
VGG_T = (1, 1, 1, 1, 1)


def configs(arch: str, monkeypatch):
    if arch == "resnet50":
        return jget_config(arch, smoke=True), get_config(arch, smoke=True)
    monkeypatch.setitem(jvision.VIT, "vit_t", VIT_T)
    monkeypatch.setitem(vision.VIT, "vit_t", VIT_T)
    monkeypatch.setitem(jvision.VGG_STAGES, "vgg_t", VGG_T)
    monkeypatch.setitem(vision.VGG_STAGES, "vgg_t", VGG_T)
    kw = dict(name=f"{arch}-test", vocab_size=10, vision_variant=arch,
              img_res=32)
    return (JConfig(family=JFamily.VISION, **kw),
            ArchConfig(family=Family.VISION, **kw))


@pytest.mark.parametrize("arch", ["resnet50", "vit_t", "vgg_t"])
def test_cold_starts_match_reference(arch, tmp_path, monkeypatch):
    jcfg, tcfg = configs(arch, monkeypatch)
    jm = jtransformer.build(jcfg)
    js = jstore.WeightStore(str(tmp_path))
    jstore.deploy_model(js, jm, "f32", jax.random.key(3))
    jstore.deploy_model(js, jm, "int8", jax.random.key(3), quant="int8")
    image = np.random.default_rng(4).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)
    want = {}
    with monkeypatch.context() as mp:
        mp.setenv("REPRO_PALLAS", "ref")
        for name in ("f32", "int8"):
            res = JEngine(jm, name, js, strategy="cicada").load(
                {"image": jnp.asarray(image)})
            want[name] = np.asarray(res.logits, np.float32)
    tm = transformer.build(tcfg, device="cpu")
    assert isinstance(tm, vision.VisionModel)
    ts = WeightStore(str(tmp_path), BandwidthModel(bandwidth_mbps=0))
    n_int8 = sum(rec["quant"] == "int8"
                 for u in ts.manifest("int8")["units"].values()
                 for rec in u["extents"])
    assert n_int8 > 0
    for name in ("f32", "int8"):
        scale = np.abs(want[name]).max()
        for strategy in STRATEGIES:
            res = ColdStartEngine(tm, name, ts, strategy=strategy,
                                  chunk_bytes=1 << 16, device="cpu").load(
                {"image": torch.from_numpy(image)})
            got = res.logits.numpy()
            assert got.shape == want[name].shape == (1, 10)
            err = np.abs(got - want[name]).max()
            assert err <= LOGIT_TOL * scale, (name, strategy, err, scale)
            assert got.argmax() == want[name].argmax(), (name, strategy)
            warm, _ = tm.forward(res.params,
                                 {"image": torch.from_numpy(image)})
            np.testing.assert_array_equal(warm.numpy(), got)
            assert sorted(res.trace.events_for("E")) == \
                sorted(tm.unit_names())
