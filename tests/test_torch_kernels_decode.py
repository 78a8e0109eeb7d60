"""The port's decode attention plain version and torch oracle against the
JAX package's oracle and its registry in ref mode, on the same numpy
inputs: GQA rep 1/3/4 and ring-window decode with per-row pos, and
against the last row of the port's flash attention.  f32 within 1e-5;
the CUDA kernel is held against the plain version by ``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
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


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.mark.parametrize("B,H,K,dh,S,pos,window", [
    (3, 8, 2, 64, 128, (3, 100, 127), 0),       # rep 4
    (3, 8, 2, 64, 128, (3, 100, 127), 128),     # ring, not yet wrapped
    (4, 6, 2, 20, 32, (0, 31, 33, 100), 32),    # rep 3, wrapped ring rows
    (2, 4, 4, 16, 48, (47, 5), 0),              # rep 1
])
def test_decode_plain_vs_jax(B, H, K, dh, S, pos, window):
    rng = np.random.default_rng(S + B)
    q = rand(rng, B, H, dh)
    kc, vc = rand(rng, B, K, S, dh), rand(rng, B, K, S, dh)
    p = np.asarray(pos, np.int32)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(p),
                                 window=window)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(p))
    close(tref.decode_attention(*args, window=window), want)
    close(tdecode.plain(*args, window=window), want)
    close(tops.decode_attention(*args, window=window),
          jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(p),
                                window=window))


def test_decode_matches_last_row_of_flash():
    """Decode over a filled cache == the last query row of causal
    attention over the same keys (the port's two plain versions)."""
    rng = np.random.default_rng(5)
    B, H, K, S, dh = 2, 6, 2, 50, 32
    q, k, v = rand(rng, B, S, H, dh), rand(rng, B, S, K, dh), \
        rand(rng, B, S, K, dh)
    full = tflash.plain(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True)
    dec = tdecode.plain(torch.from_numpy(q[:, -1]),
                        torch.from_numpy(k).transpose(1, 2).contiguous(),
                        torch.from_numpy(v).transpose(1, 2).contiguous(),
                        torch.full((B,), S - 1, dtype=torch.int32))
    close(dec, full[:, -1])
