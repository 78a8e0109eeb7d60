"""The backward kernels' plain versions and the autograd wiring around
them, on the CPU: ``flash_attention_bwd.plain`` (fed the forward's output
and log-sum-exp) against torch autograd of ``flash_attention.plain`` and
against ``jax.grad`` of the reference's ``_xla_flash``, over GQA, windows,
non-causal, dh 20/64/80/256 and a row with no key; ``rmsnorm.plain_bwd``
against autograd of ``rmsnorm.plain`` and ``jax.grad`` of the reference's
``rmsnorm``; ``ops.flash_attention`` / ``ops.rmsnorm`` take the autograd
functions only where a gradient is wanted; and a failing library launch
raises, never falls back."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import _xla_flash
from repro.models.layers import rmsnorm as jrmsnorm
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import flash_attention_bwd as bmod
from repro_torch.kernels import rmsnorm as nmod
from torch_testlib import elsewhere

torch.set_num_threads(2)
TOL = 1e-5          # of each gradient's max |g|, f32 against f32

# (B, S, T, H, K, dh, causal, window)
FLASH = [(2, 24, 24, 6, 2, 20, True, 0),          # smollm smoke's GQA
         (1, 40, 40, 8, 2, 64, True, 16),         # causal window
         (1, 33, 33, 4, 4, 80, False, 0),         # hubert: non-causal
         (1, 30, 30, 4, 2, 64, False, 8),         # non-causal window
         (1, 20, 20, 2, 1, 256, True, 0),         # dh 256
         (2, 7, 4, 4, 2, 16, True, 0)]            # S > T: rows with no key


def _rand(r, *shape):
    return torch.from_numpy(r.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    b = np.asarray(b, np.float32)
    return np.abs(np.asarray(a, np.float32) - b).max() / max(
        np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_plain_bwd(case):
    B, S, T, H, K, dh, causal, win = case
    r = np.random.default_rng(sum(case))
    q, k, v = _rand(r, B, S, H, dh), _rand(r, B, T, K, dh), \
        _rand(r, B, T, K, dh)
    do = _rand(r, B, S, H, dh)
    o, lse = fmod.plain(q, k, v, causal=causal, window=win, return_lse=True)
    got = bmod.plain(q, k, v, o, lse, do, causal=causal, window=win)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fmod.plain(qa, ka, va, causal=causal,
                                          window=win), (qa, ka, va), do)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _rel(g, w) <= TOL
    if S > T:
        assert torch.isinf(lse[:, :, :S - T]).all()
        assert not got[0][:, :S - T].any()            # no key: no gradient
        return                   # the reference gives such a row the mean
    # jax.grad of the reference's jnp flash attention (B, H, S, dh)
    jq, jk, jv = (jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v))
    _, vjp = jax.vjp(lambda a, b_, c: _xla_flash(
        a, b_, c, causal=causal, window=win), jq, jk, jv)
    jg = vjp(jnp.asarray(do.transpose(1, 2).numpy()))
    for g, w in zip(got, jg):
        assert _rel(g.transpose(1, 2).numpy(), w) <= 1e-4


@pytest.mark.parametrize("shape,dt", [((3, 5, 20), torch.float32),
                                      ((4, 960), torch.float32),
                                      ((2, 7, 64), torch.bfloat16)])
def test_rmsnorm_plain_bwd(shape, dt):
    r = np.random.default_rng(len(shape))
    x = (_rand(r, *shape) * 3).to(dt)
    sc = _rand(r, shape[-1]) * 0.1
    g = _rand(r, *shape).to(dt)
    dx, ds = nmod.plain_bwd(x, sc, g)
    assert dx.dtype == dt and ds.dtype == torch.float32
    xa, sa = x.clone().requires_grad_(), sc.clone().requires_grad_()
    want = torch.autograd.grad(nmod.plain(xa, sa), (xa, sa), g)
    tol = TOL if dt == torch.float32 else 2e-2
    assert _rel(dx.float(), want[0].float()) <= tol
    assert _rel(ds, want[1]) <= tol
    if dt == torch.float32:
        _, vjp = jax.vjp(jrmsnorm, jnp.asarray(x.numpy()),
                         jnp.asarray(sc.numpy()))
        jdx, jds = vjp(jnp.asarray(g.numpy()))
        assert _rel(dx, jdx) <= 1e-5 and _rel(ds, jds) <= 1e-5


def test_autograd_functions_only_where_a_gradient_is_wanted(monkeypatch):
    """Without a gradient the model's entries run the forward as serving
    always has (no log-sum-exp, no saved tensors); with one, the autograd
    functions, whose backwards are the plain formulas on the CPU and
    count no launch."""
    r = np.random.default_rng(5)
    q, k = _rand(r, 1, 9, 4, 20), _rand(r, 1, 9, 2, 20)
    x, sc = _rand(r, 3, 20), _rand(r, 20) * 0.1
    calls = []
    for mod, name in ((fmod, "FlashAttention"), (nmod, "RMSNorm")):
        fn = getattr(mod, name)
        monkeypatch.setattr(fn, "apply", (lambda f, n: lambda *a: (
            calls.append(n), f(*a))[1])(fn.apply, name))
    assert torch.equal(ops.flash_attention(q, k, k, window=4),
                       fmod.plain(q, k, k, window=4))
    assert torch.equal(ops.rmsnorm(x, sc), nmod.plain(x, sc))
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, k)
        ops.rmsnorm(x.requires_grad_(), sc)
    assert calls == []
    ops.registry.reset_counts()
    o = ops.flash_attention(q, k, k, window=4)
    y = ops.rmsnorm(x, sc)
    assert calls == ["FlashAttention", "RMSNorm"]
    (o.square().sum() + y.square().sum()).backward()
    assert q.grad is not None and x.grad is not None
    assert sum(ops.registry.dispatch_snapshot().values()) == 0


def test_plain_lse():
    r = np.random.default_rng(6)
    q, k = _rand(r, 2, 6, 4, 8), _rand(r, 2, 6, 2, 8)
    _, lse = fmod.plain(q, k, k, causal=True, window=3, return_lse=True)
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, 2)) / \
        math.sqrt(8)
    i = torch.arange(6)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 3)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    assert lse.shape == (2, 4, 6) and lse.dtype == torch.float32


class _FailingLib:
    def __getattr__(self, name):
        return lambda *a: 700            # cudaErrorIllegalAddress


def test_failing_launch_raises(monkeypatch):
    """A launch the library refuses raises RuntimeError in each backward
    wrapper's launch step and counts nothing: there is no plain fallback
    for a CUDA tensor."""
    import contextlib
    monkeypatch.setattr(cuda_lib, "library", lambda: _FailingLib())
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    ops.registry.reset_counts()
    r = np.random.default_rng(7)
    q, k = _rand(r, 1, 8, 2, 16), _rand(r, 1, 8, 1, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(RuntimeError, match="flash_attention_bwd: CUDA launch"):
        bmod._launch(q, k, k, q, q, lse, q.clone(), k.clone(), k.clone(),
                     lse.clone(), causal=True, window=0)
    x = _rand(r, 4, 16)
    with pytest.raises(RuntimeError, match="rmsnorm_bwd: CUDA launch"):
        nmod._launch_bwd(x, x[0], x, x.clone(), torch.zeros(1, 16),
                         torch.zeros(16), 4, 16, 1e-6)
    snap = ops.registry.dispatch_snapshot()
    assert snap["flash_attention_bwd"] == 0 and snap["rmsnorm_bwd"] == 0
    t = elsewhere(1, 4, 2, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        bmod.flash_attention_bwd(t, t, t, t, elsewhere(1, 2, 16), t)
    with pytest.raises(ValueError, match="unsupported device"):
        nmod.rmsnorm_bwd(t, elsewhere(16), t)


def test_registry_holds_the_backward_kernels():
    for name, plain, source in (
            ("flash_attention_bwd", bmod.plain, "flash_attention_bwd.cu"),
            ("rmsnorm_bwd", nmod.plain_bwd, "rmsnorm.cu")):
        spec = ops.registry.spec(name)
        assert spec.plain is plain and spec.source.endswith(source)
    assert ops.registry.spec("rmsnorm_bwd").counter is nmod.bwd_launches
    # the forward's entry takes the log-sum-exp pointer after o
    assert cuda_lib.SIGNATURES["repro_flash_attention"][4] is cuda_lib.P
