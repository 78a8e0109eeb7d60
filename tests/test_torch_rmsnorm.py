"""rmsnorm and the rows probe: the repair of the scheduler's bit-identity
with ``reference_generate`` on bf16-resident weights.

The probe (``kernels/ab.py::probe_rows``) runs one decode step at B = 1 and
at B = 4 with the same row in slot 0 and compares every torch op on that
row, each on repaired inputs.  On the card it found one op whose row
depended on the batch: the mean of rmsnorm (PyTorch sizes its reduction's
blocks from the number of rows).  ``csrc/rmsnorm.cu`` sums a row in one
block in an order fixed by the row alone; that order is emulated here and
its rows are bit-equal at M in {1, 4, 16}, within 1e-5 of the plain version
and of the JAX package's rmsnorm.  On the CPU the wrapper takes the plain
version, which is the reference's op for op.  The probe itself is held to
what it must see: nothing on a row-independent model, and an op made to
depend on the batch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch import tree as tree_util
from repro_torch.kernels import ab, ops
from repro_torch.kernels import rmsnorm as trms
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config

torch.set_num_threads(2)
THREADS = 256                    # csrc/rmsnorm.cu: one block a row


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def kernel_order(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """csrc/rmsnorm.cu's order: thread t sums x_i^2 for i = t, t + 256, ...
    in order; lanes by the butterfly xor 16, 8, 4, 2, 1; the 8 warps in
    warp order; then x r (1 + scale) with r = rsqrt(sum / d + eps)."""
    dt = x.dtype
    xf = x.float()
    d = xf.shape[-1]
    sq = torch.nn.functional.pad(xf * xf, (0, -d % THREADS))
    sq = sq.reshape(*xf.shape[:-1], -1, THREADS)
    s = torch.zeros(sq.shape[:-2] + (THREADS,))
    for k in range(sq.shape[-2]):
        s = s + sq[..., k, :]
    s = s.reshape(*s.shape[:-1], THREADS // 32, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ off]
    total = torch.zeros(s.shape[:-2])
    for w in range(THREADS // 32):
        total = total + s[..., w, 0]
    r = torch.rsqrt(total * (1.0 / d) + eps)[..., None]
    return ((xf * r) * (1.0 + scale.float())).to(dt)


@pytest.mark.parametrize("d", [20, 960, 2560, 3072])
def test_kernel_order_rows_bit_equal_and_close(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((16, d), dtype=np.float32)) * 3
    scale = torch.from_numpy(rng.standard_normal(d, dtype=np.float32)) * 0.1
    rows = torch.cat([kernel_order(x[i:i + 1], scale) for i in range(16)])
    for m in (1, 4, 16):
        assert torch.equal(kernel_order(x[:m], scale), rows[:m])
    torch.testing.assert_close(rows, trms.plain(x, scale), atol=1e-5,
                               rtol=1e-5)
    want = jlayers.rmsnorm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_reference_op_for_op(dtype):
    """The CPU path (layers.rmsnorm -> ops.rmsnorm -> plain) against the
    JAX rmsnorm: f32 within 1e-6, bf16 within one bf16 step."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64), dtype=np.float32))
    scale = torch.from_numpy(rng.standard_normal(64, dtype=np.float32)) * 0.1
    got = tlayers.rmsnorm(x.to(dtype), scale.to(dtype))
    assert got.dtype == dtype and torch.equal(
        got, trms.plain(x.to(dtype), scale.to(dtype)))
    want = jlayers.rmsnorm(jnp.asarray(x.to(dtype).float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(scale.to(dtype).float().numpy()))
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_registry_carries_rmsnorm():
    spec = ops.registry.spec("rmsnorm")
    assert spec.source.endswith("csrc/rmsnorm.cu")
    assert spec.replaces == "src/repro/models/layers.py:44"
    ops.registry.reset_counts()
    tlayers.rmsnorm(torch.ones(2, 8), torch.zeros(8))
    assert ops.registry.dispatch_snapshot()["rmsnorm"] == 0   # CPU: plain


def bf16_model(arch):
    cfg = get_config(arch, smoke=True)
    model = ttransformer.build(cfg, device="cpu")
    params = tree_util.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t,
        model.init(0))
    base = np.random.default_rng(0).integers(0, cfg.vocab_size, (40,))
    return model, params, [base[:s] for s in (40, 7, 13, 29)]


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_probe_sees_no_batch_dependence_in_a_row_independent_step(arch):
    model, params, prompts = bf16_model(arch)
    r = ab.probe_rows(model, params, prompts, cache_len=64)
    assert r["misaligned"] is None and r["compared"] == r["ops"] > 100
    assert r["first"] is None and not r["sources"] and r["logits_equal"]


def test_probe_finds_an_op_that_depends_on_the_batch(monkeypatch):
    """A norm made to scale its rows by the batch size: the probe names
    its op and the line of the model that called it, and only that op
    (every later op is judged on repaired inputs)."""
    model, params, prompts = bf16_model("smollm-360m")

    def batch_norm(x, scale, eps=1e-6):
        return trms.plain(x, scale, eps) * (1.0 + 0.01 * (x.shape[0] - 1))

    monkeypatch.setattr(ops, "rmsnorm", batch_norm)
    r = ab.probe_rows(model, params, prompts, cache_len=64)
    n_norms = 2 * model.cfg.n_layers + 1
    assert r["first"] is not None and "models/layers.py" in r["first"]
    assert sum(r["sources"].values()) == n_norms
    assert all(w.startswith("mul at repro_torch/models/layers.py")
               for w in r["sources"])
