"""The port's flash attention plain version and torch oracle against the
JAX package's oracle (``repro.kernels.ref``) and its registry in ref mode
(``repro.kernels.ops`` with ``REPRO_PALLAS=ref``), on the same numpy
inputs, over the cases ``tests/test_kernels.py`` sweeps: GQA rep 1/3/4,
causal and not, windows, T > S, ragged S and T, fully masked rows.

Tolerance: f32 within 1e-5 (the two compute the same f32 sums in a
different order).  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.  Decode attention and
weight_transform have their own files (``test_torch_kernels_*.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_testlib import close, rand

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


FLASH_CASES = [
    # B, H, K, S, T, dh
    (1, 4, 4, 128, 128, 64),      # MHA (rep 1)
    (2, 8, 2, 96, 96, 64),        # GQA rep 4
    (1, 6, 2, 37, 37, 32),        # GQA rep 3, ragged S
    (1, 3, 1, 45, 101, 16),       # MQA, T > S, ragged both
]


# non-causal attention with T != S is left out: the reference oracle
# measures its window from query index i, its kernel from position T - S + i
@pytest.mark.parametrize("B,H,K,S,T,dh,causal,window", [
    c + m for c in FLASH_CASES
    for m in [(True, 0), (True, 16), (False, 0), (False, 16)]
    if m[0] or c[3] == c[4]])
def test_flash_plain_vs_jax(B, H, K, S, T, dh, causal, window):
    rng = np.random.default_rng(S * 7 + T)
    q, k, v = rand(rng, B, H, S, dh), rand(rng, B, K, T, dh), \
        rand(rng, B, K, T, dh)
    want = jref.mha_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, window=window)
    # the port's torch oracle is the reference oracle, op for op
    close(tref.mha_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window), want)
    # the kernel's plain version, in the model layout (B, S, H, dh)
    qs = torch.from_numpy(q).transpose(1, 2)
    ks = torch.from_numpy(k).transpose(1, 2)
    vs = torch.from_numpy(v).transpose(1, 2)
    got = tflash.plain(qs, ks, vs, causal=causal, window=window)
    close(got.transpose(1, 2), want)
    # ... and the reference registry's ref-mode wrapper, same layout
    jgot = jops.flash_attention(jnp.asarray(np.swapaxes(q, 1, 2)),
                                jnp.asarray(np.swapaxes(k, 1, 2)),
                                jnp.asarray(np.swapaxes(v, 1, 2)),
                                causal=causal, window=window)
    close(got, jgot)
    # the wrapper takes the plain version for CPU tensors
    close(tops.flash_attention(qs, ks, vs, causal=causal, window=window), got)


def test_flash_fully_masked_rows_give_zero():
    """T < S causal: the first S - T queries sit before every key.  The
    port (like the TPU kernel, whose masked tiles never run) gives 0 for
    such rows; the JAX oracle's finite -1e30 mask gives the mean of V
    there, so only the other rows are compared with it."""
    rng = np.random.default_rng(3)
    B, H, K, S, T, dh = 1, 4, 2, 40, 24, 32
    q, k, v = rand(rng, B, H, S, dh), rand(rng, B, K, T, dh), \
        rand(rng, B, K, T, dh)
    want = np.asarray(jref.mha_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))
    got = tflash.plain(torch.from_numpy(q).transpose(1, 2),
                       torch.from_numpy(k).transpose(1, 2),
                       torch.from_numpy(v).transpose(1, 2),
                       causal=True).transpose(1, 2).numpy()
    masked = S - T
    np.testing.assert_array_equal(got[:, :, :masked], 0.0)
    close(got[:, :, masked:], want[:, :, masked:])
