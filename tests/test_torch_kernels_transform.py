"""The port's weight_transform plain version against the JAX package's
oracle on odd shapes: int8 dequant to f32 and bf16, and the f32 -> bf16
cast, exactly (it is elementwise).  The CUDA kernel is held against the
plain version by ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import weight_transform as twt
from torch_testlib import rand

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.mark.parametrize("n,m", [(64, 64), (100, 70), (17, 300), (1, 1),
                                 (720, 20)])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_weight_transform_dequant_exact(n, m, out):
    rng = np.random.default_rng(n * m)
    w8 = rng.integers(-127, 128, (n, m)).astype(np.int8)
    sc = (np.abs(rand(rng, m)) * 0.01 + 1e-4).astype(np.float32)
    want = jref.weight_transform(jnp.asarray(w8), jnp.asarray(sc),
                                 getattr(jnp, out))
    got = twt.plain(torch.from_numpy(w8), torch.from_numpy(sc),
                    out_dtype=getattr(torch, out))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        tops.weight_transform(torch.from_numpy(w8), torch.from_numpy(sc),
                              out_dtype=getattr(torch, out)).float().numpy(),
        got.float().numpy())


@pytest.mark.parametrize("n,m", [(50, 130), (3, 7)])
def test_weight_transform_cast_exact(n, m):
    w = rand(np.random.default_rng(n), n, m)
    want = jref.weight_transform(jnp.asarray(w), None, jnp.bfloat16)
    got = twt.plain(torch.from_numpy(w), None, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
