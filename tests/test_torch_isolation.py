"""Boundaries of the port: it imports neither JAX nor the JAX package (here
for its top-level modules, ``chip_smoke.py`` and the subpackages not
checked by ``test_torch_isolation_{core,kernels}.py``); its
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
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.serving.decode import reference_generate
from repro_torch.store.store import WeightStore, deploy_model
from torch_testlib import (PORT, ROOT, assert_imports_no_jax_and_no_reference,
                           path_id, port_files)

torch.set_num_threads(2)
HERE = ("", "analysis", "configs", "store")
# the subpackages test_torch_isolation_{core,kernels}.py check
ELSEWHERE = ("core", "serving", "kernels", "models")


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
                    "weight_transform.cu"]
    for name in ops.registry.names():
        mod = ops.registry.spec(name).module
        assert (ROOT / mod.SOURCE).exists()
        assert mod.REPLACES.startswith("src/repro/kernels/")


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
    # the same calls on device="cpu" run
    ColdStartEngine(m, "m", store, device="cpu")
    assert len(reference_generate(m, params, [1, 2, 3], n_new=2,
                                  device="cpu")) == 2


def test_cpu_tensors_take_plain_versions_and_count_nothing(tmp_path):
    ops.registry.reset_counts()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 64),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 64),
                                             dtype=np.float32))
    torch.testing.assert_close(
        ops.flash_attention(q, k, k, causal=True),
        ops.registry.spec("flash_attention").module.plain(q, k, k, causal=True),
        rtol=0, atol=0)
    kc = k.transpose(1, 2).contiguous()
    pos = torch.tensor([5], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q[:, 0], kc, kc, pos),
        ops.registry.spec("decode_attention").module.plain(q[:, 0], kc, kc, pos),
        rtol=0, atol=0)
    w = torch.randint(-127, 128, (7, 5), dtype=torch.int8)
    s = torch.rand(5)
    assert torch.equal(ops.weight_transform(w, s, out_dtype=torch.float32),
                       (w.float() * s).float())
    # a whole cold start + generation on the CPU launches no kernel
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              compute_dtype=torch.float32)
    m = transformer.build(cfg, device="cpu")
    store = WeightStore(str(tmp_path))
    deploy_model(store, m, "q", quant="int8")
    res = ColdStartEngine(m, "q", store, device="cpu").load(
        {"tokens": torch.tensor([[1, 2, 3, 4]])})
    reference_generate(m, res.params, [1, 2, 3], n_new=3, device="cpu")
    assert ops.registry.dispatch_snapshot() == {
        "decode_attention": 0, "flash_attention": 0, "weight_transform": 0}
    assert ops.registry.describe()["library"]["built"] is False


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.weight_transform(meta, None)
