"""Boundaries of the port: it imports neither JAX nor the JAX package (here
for its top-level modules, ``chip_smoke.py`` and the subpackages not
checked by ``test_torch_isolation_{core,serving,kernels}.py``, and the
training modules imported in a process where ``jax`` and ``repro``
cannot be imported); its
entry points run on the GPU unless told ``device="cpu"`` and raise when
there is none; CPU tensors take the plain versions and count no kernel
launch."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ColdStartEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib, ops
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer, vision
from repro_torch.models.api import get_config
from repro_torch.serving import (DecodeScheduler, GenerateSpec,
                                 InstancePool, ServerlessPlatform)
from repro_torch.serving.decode import reference_generate
from repro_torch.store.store import WeightStore, deploy_model
from torch_testlib import (PORT, ROOT, assert_imports_no_jax_and_no_reference,
                           path_id, port_files)

torch.set_num_threads(2)
HERE = ("", "analysis", "configs", "distributed", "launch", "store",
        "training")
# the subpackages test_torch_isolation_{core,serving,kernels}.py check
ELSEWHERE = ("core", "serving", "cluster", "kernels", "models")


@pytest.mark.parametrize("path", port_files(*HERE), ids=path_id)
def test_port_imports_no_jax_and_no_reference(path):
    assert_imports_no_jax_and_no_reference(path)


def test_import_checks_cover_every_port_file():
    every = set(PORT.rglob("*.py")) | {ROOT / "chip_smoke.py"}
    checked = port_files(*HERE, *ELSEWHERE)
    assert len(checked) == len(set(checked))
    assert set(checked) == every


def test_port_has_its_kernel_sources():
    srcs = sorted(p.name for p in cuda_lib.CSRC.glob("*.cu"))
    assert srcs == ["decode_attention.cu", "flash_attention.cu",
                    "flash_attention_bwd.cu", "quant_matmul.cu",
                    "rglru_scan.cu", "rmsnorm.cu", "ssd_scan.cu",
                    "ssd_scan_bwd.cu", "weight_transform.cu"]
    assert ops.registry.names() == [
        "decode_attention", "decode_attention_paged", "flash_attention",
        "flash_attention_bwd", "quant_matmul", "rglru_scan",
        "rglru_scan_bwd", "rmsnorm", "rmsnorm_bwd", "ssd_scan",
        "ssd_scan_bwd", "weight_transform"]
    for name in ops.registry.names():
        spec = ops.registry.spec(name)
        assert (ROOT / spec.source).exists()
        path, line = spec.replaces.split(":")
        # the TPU kernels; rmsnorm (and its backward) stands for the
        # reference's jnp rmsnorm, the other backwards for the jnp flash
        # attention and scans jax.grad differentiates
        assert path.startswith("src/repro/kernels/") or (
            name in ("rmsnorm", "rmsnorm_bwd")
            and path == "src/repro/models/layers.py")
        assert "def " in (ROOT / path).read_text().splitlines()[int(line) - 1]


BLOCKED = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for mod in sys.argv[1:]:
    __import__(mod)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax"))
assert not bad, bad
print("OK")
"""


def test_training_modules_import_with_jax_and_reference_blocked():
    """The training path imports in a process where importing ``jax`` or
    ``repro`` raises."""
    import os
    import subprocess
    import sys
    mods = ["repro_torch.training", "repro_torch.training.data",
            "repro_torch.training.optim", "repro_torch.training.train",
            "repro_torch.distributed.checkpoint",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.resilience",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.train"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKED, *mods], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", \
        out.stderr[-2000:]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    cfg = get_config("smollm-360m", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.build(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    m = transformer.build(cfg, device="cpu")
    store = WeightStore(str(tmp_path))
    deploy_model(store, m, "m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColdStartEngine(m, "m", store)
    params = m.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reference_generate(m, params, [1, 2, 3], n_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServerlessPlatform(store, {"m": lambda: (m, None)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InstancePool("m", lambda: (m, None), store)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_serving_mesh((1, 4))
    # the same calls on device="cpu" run
    ColdStartEngine(m, "m", store, device="cpu")
    assert len(reference_generate(m, params, [1, 2, 3], n_new=2,
                                  device="cpu")) == 2


def test_vision_models_need_a_device(no_cuda, tmp_path):
    """The vision family's entry points run on the GPU unless told
    device="cpu", like the LMs'; on the CPU a whole int8 cold start
    launches no kernel."""
    cfg = get_config("vgg11", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vision.build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.build(cfg)
    m = vision.build(cfg, device="cpu")
    assert transformer.build(cfg, device="cpu") is m
    assert m.device == torch.device("cpu")
    store = WeightStore(str(tmp_path))
    deploy_model(store, m, "v", quant="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColdStartEngine(m, "v", store)
    ops.registry.reset_counts()
    res = ColdStartEngine(m, "v", store, device="cpu").load(
        {"image": torch.zeros(1, 3, 32, 32)})
    assert res.logits.shape == (1, 10)
    assert sum(ops.registry.dispatch_snapshot().values()) == 0


def test_cpu_tensors_take_plain_versions_and_count_nothing(tmp_path):
    ops.registry.reset_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 64),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 64),
                                             dtype=np.float32))
    torch.testing.assert_close(
        ops.flash_attention(q, k, k, causal=True),
        ops.registry.spec("flash_attention").plain(q, k, k, causal=True),
        rtol=0, atol=0)
    kc = k.transpose(1, 2).contiguous()
    pos = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q[:, 0], kc, kc, pos),
        ops.registry.spec("decode_attention").plain(q[:, 0], kc, kc, pos),
        rtol=0, atol=0)
    pages = kc.reshape(2, 1, 9, 64)[:, :, :8]       # (P=2, K=1, pt=8, dh)
    tables = torch.tensor([[1, 0]], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention_paged(q[:, 0, :1], pages, pages, tables, pos),
        ops.registry.spec("decode_attention_paged").plain(
            q[:, 0, :1], pages, pages, tables, pos), rtol=0, atol=0)
    x = torch.from_numpy(rng.standard_normal((3, 7), dtype=np.float32))
    torch.testing.assert_close(
        ops.quant_matmul(x, w := torch.randint(-127, 128, (7, 5),
                                                dtype=torch.int8),
                         s := torch.rand(5)),
        ops.registry.spec("quant_matmul").plain(x, w, s), rtol=0, atol=0)
    assert torch.equal(ops.weight_transform(w, s, out_dtype=torch.float32),
                       (w.float() * s).float())
    xs = torch.from_numpy(rng.standard_normal((1, 2, 5, 4), dtype=np.float32))
    dt, A = torch.rand(1, 2, 5) * 0.1, -torch.rand(2) - 0.1
    Bm = torch.from_numpy(rng.standard_normal((1, 5, 3), dtype=np.float32))
    torch.testing.assert_close(
        ops.ssd_scan(xs, dt, A, Bm, Bm),
        ops.registry.spec("ssd_scan").plain(xs, dt, A, Bm, Bm),
        rtol=0, atol=0)
    a = torch.rand(2, 5, 3)
    torch.testing.assert_close(
        ops.rglru_scan(a, a), ops.registry.spec("rglru_scan").plain(a, a),
        rtol=0, atol=0)
    # a whole cold start + generation on the CPU launches no kernel
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype=torch.float32)
    m = transformer.build(cfg, device="cpu")
    store = WeightStore(str(tmp_path))
    deploy_model(store, m, "q", quant="int8")
    res = ColdStartEngine(m, "q", store, device="cpu").load(
        {"tokens": torch.tensor([[1, 2, 3, 4]])})
    reference_generate(m, res.params, [1, 2, 3], n_new=3, device="cpu")
    qres = ColdStartEngine(m, "q", store, compute_quant=True,
                           device="cpu").load({"tokens": torch.tensor([[1]])})
    sched = DecodeScheduler(m, qres.params, n_slots=2, cache_len=16,
                            kv_page_tokens=4)
    sched.generate(GenerateSpec(prompt=[1, 2, 3], n_new=3))
    assert set(sched.kernel_modes().values()) == {"plain"}
    # and so does a recurrent (hybrid) one
    hcfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True),
                               compute_dtype=torch.float32)
    hm = transformer.build(hcfg, device="cpu")
    deploy_model(store, hm, "h", quant="int8")
    hres = ColdStartEngine(hm, "h", store, device="cpu").load(
        {"tokens": torch.tensor([[1, 2, 3, 4]])})
    DecodeScheduler(hm, hres.params, n_slots=2, cache_len=16).generate(
        GenerateSpec(prompt=[1, 2, 3], n_new=3))
    assert ops.registry.dispatch_snapshot() == {
        "decode_attention": 0, "decode_attention_paged": 0,
        "flash_attention": 0, "flash_attention_bwd": 0, "quant_matmul": 0,
        "rglru_scan": 0, "rglru_scan_bwd": 0, "rmsnorm": 0,
        "rmsnorm_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
        "weight_transform": 0}
    assert ops.registry.describe()["library"]["built"] is False


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.weight_transform(meta, None)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.quant_matmul(meta.float(), meta, meta[0].float())
    q = torch.empty((1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention_paged(q, q[None], q[None],
                                   meta[:1].int(), meta[0, :1].int())
