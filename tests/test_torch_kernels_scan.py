"""The port's scan kernels' plain versions and ops wrappers against the JAX
package, on the same numpy inputs: ``ssd`` / ``ssd_scan`` against JAX's
``ref.ssd`` and ``ops._xla_ssd`` and ``rglru`` / ``rglru_scan`` against
``ref.rglru`` and ``ops._xla_rglru`` over the shapes
``tests/test_kernels.py`` sweeps, with an initial state and the final
state; the wrappers' padding of a sequence the chunk does not divide;
the decode steps against the scans; and the plain attention at head dim
256 (recurrentgemma) against JAX's ``ref``.  Tolerances: f32 1e-4 (the
chunked and sequential forms sum in other orders), bf16 one bf16 ulp of
max |y| (both round the same f32 result)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_testlib import close, rand

torch.set_num_threads(2)
F32 = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def ssd_inputs(rng, b, nh, S, dp, N):
    return (rand(rng, b, nh, S, dp),
            np.abs(rand(rng, b, nh, S)) * 0.1 + 0.01,
            -np.abs(rand(rng, nh)) - 0.1,
            rand(rng, b, S, N) * 0.3, rand(rng, b, S, N) * 0.3)


def rglru_inputs(rng, B, S, W):
    return np.abs(rand(rng, B, S, W)) * 0.2 + 0.5, rand(rng, B, S, W)


def j(*xs):
    return [jnp.asarray(x) for x in xs]


def t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("b,nh,S,dp,N,bc", [
    (1, 2, 64, 16, 32, 16),
    (2, 3, 128, 32, 64, 64),
    (1, 1, 96, 16, 16, 32),
])
def test_ssd_matches_jax_with_states(b, nh, S, dp, N, bc):
    rng = np.random.default_rng(S + N)
    xs = ssd_inputs(rng, b, nh, S, dp, N)
    h0 = rand(rng, b, nh, dp, N) * 0.5
    y_j, h_j = jref.ssd(*j(*xs), h0=jnp.asarray(h0), return_state=True)
    y_x = jops._xla_ssd(*j(*xs), bc=bc)
    y_t, h_t = tops.ssd_scan(*t(*xs), bc=bc, h0=torch.from_numpy(h0),
                             return_state=True)
    close(y_t, y_j, **F32)
    close(h_t, h_j, **F32)
    close(tops.ssd_scan(*t(*xs), bc=bc), y_x, **F32)     # from zero
    close(tref.ssd(*t(*xs)), jref.ssd(*j(*xs)), **F32)


def test_ssd_bf16_matches_jax():
    rng = np.random.default_rng(3)
    x, dt, A, B, C = ssd_inputs(rng, 2, 3, 40, 16, 32)
    xb = jnp.asarray(x, jnp.bfloat16)
    y_j = np.asarray(jref.ssd(xb, *j(dt, A, B, C)), np.float32)
    y_t = tops.ssd_scan(torch.from_numpy(x).bfloat16(), *t(dt, A, B, C),
                        bc=16)
    assert y_t.dtype == torch.bfloat16
    close(y_t.float(), y_j, atol=2 ** -8 * np.abs(y_j).max(), rtol=0)


def test_ssd_ops_pads_nondivisible_seq():
    """S = 50 over chunks of 16: dt = 0 padding leaves the final state as
    the unpadded recurrence's, and the outputs are sliced back to S."""
    rng = np.random.default_rng(5)
    xs = ssd_inputs(rng, 2, 2, 50, 8, 16)
    y_j = jops.ssd_scan(*j(*xs), bc=16)                  # JAX pads too
    y_t, h_t = tops.ssd_scan(*t(*xs), bc=16, return_state=True)
    _, h_ref = jref.ssd(*j(*xs), return_state=True)
    assert tuple(y_t.shape) == (2, 2, 50, 8)
    close(y_t, y_j, **F32)
    close(h_t, h_ref, **F32)


@pytest.mark.parametrize("B,S,W,bc", [(1, 64, 32, 16), (3, 128, 48, 64),
                                      (2, 80, 16, 16)])
def test_rglru_matches_jax_with_states(B, S, W, bc):
    rng = np.random.default_rng(S + W)
    a, b = rglru_inputs(rng, B, S, W)
    h0 = rand(rng, B, W)
    y_j, h_j = jref.rglru(*j(a, b), h0=jnp.asarray(h0), return_state=True)
    y_t, h_t = tops.rglru_scan(*t(a, b), bc=bc, h0=torch.from_numpy(h0),
                               return_state=True)
    close(y_t, y_j, atol=1e-5, rtol=1e-5)
    close(h_t, h_j, atol=1e-5, rtol=1e-5)
    close(tops.rglru_scan(*t(a, b), bc=bc), jops._xla_rglru(*j(a, b)),
          atol=1e-5, rtol=1e-5)


def test_rglru_ops_pads_and_keeps_the_true_final_state():
    """S = 37 over chunks of 16: the trailing zero steps would reset h to
    0, so the final state must be the one after step S - 1."""
    rng = np.random.default_rng(7)
    a, b = rglru_inputs(rng, 2, 37, 24)
    y_t, h_t = tops.rglru_scan(*t(a, b), bc=16, return_state=True)
    y_j, h_j = jref.rglru(*j(a, b), return_state=True)
    assert tuple(y_t.shape) == (2, 37, 24)
    assert float(h_t.abs().min()) > 0
    close(y_t, y_j, atol=1e-5, rtol=1e-5)
    close(h_t, h_j, atol=1e-5, rtol=1e-5)


def test_decode_steps_match_scans_and_jax():
    rng = np.random.default_rng(11)
    x, dt, A, B, C = ssd_inputs(rng, 2, 2, 12, 8, 16)
    y_scan = tops.ssd_scan(*t(x, dt, A, B, C))
    h_t, h_j = torch.zeros(2, 2, 8, 16), jnp.zeros((2, 2, 8, 16))
    for s in range(12):
        h_t, y = tops.ssd_step(h_t, *t(x[:, :, s], dt[:, :, s], A, B[:, s],
                                       C[:, s]))
        h_j, y_j = jops.ssd_step(h_j, *j(x[:, :, s], dt[:, :, s], A,
                                         B[:, s], C[:, s]))
        close(y, y_scan[:, :, s], **F32)
        close(y, y_j, **F32)
    a, b = rglru_inputs(rng, 2, 12, 8)
    y_scan = tops.rglru_scan(*t(a, b))
    h_t, h_j = torch.zeros(2, 8), jnp.zeros((2, 8))
    for s in range(12):
        h_t = tops.rglru_step(h_t, *t(a[:, s], b[:, s]))
        h_j = jops.rglru_step(h_j, *j(a[:, s], b[:, s]))
        close(h_t, y_scan[:, s], atol=1e-5, rtol=1e-5)
        close(h_t, h_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,T,window", [(128, 128, 0), (40, 72, 0),
                                        (77, 77, 16)])
def test_flash_plain_dh256_matches_jax(S, T, window):
    """recurrentgemma's attention: 10 query heads of dh 256 over 1 kv
    head (and a windowed case, which the kernel also takes)."""
    rng = np.random.default_rng(S)
    q, k, v = rand(rng, 1, 10, S, 256), rand(rng, 1, 1, T, 256), \
        rand(rng, 1, 1, T, 256)
    want = jref.mha_attention(*j(q, k, v), causal=True, window=window)
    got = tflash.flash_attention(*(x.transpose(1, 2) for x in t(q, k, v)),
                                 causal=True, window=window)
    close(got.transpose(1, 2), want, **F32)


def test_decode_plain_dh256_matches_jax():
    rng = np.random.default_rng(13)
    q, kc, vc = rand(rng, 3, 10, 256), rand(rng, 3, 1, 64, 256), \
        rand(rng, 3, 1, 64, 256)
    pos = np.array([0, 31, 63], np.int32)
    want = jref.decode_attention(*j(q, kc, vc, pos))
    got = tdecode.decode_attention(*t(q, kc, vc, pos))
    close(got, want, **F32)
