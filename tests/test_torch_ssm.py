"""The port's Mamba-2 SSD block against ``repro.models.ssm`` on the same
params and inputs (mamba2-780m smoke, f32 compute, ``REPRO_PALLAS=ref``),
within 1e-4: the causal conv with a carried state, the block with and
without its states, one decode step; and, mirroring
``tests/test_ssm_griffin.py``, decode against the full sequence, state
continuation and causality; and the reference's init rules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.api import get_config as jget_config
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from torch_testlib import close, rand

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jget_config("mamba2-780m", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("mamba2-780m", smoke=True),
                               compute_dtype=torch.float32)
    jp = jssm.ssd_params(jcfg, jax.random.key(0))
    # non-trivial gates: the init's zeros would hide a wrong a_log or
    # dt_bias read
    rng = np.random.default_rng(0)
    jp = dict(jp, a_log=jnp.asarray(rand(rng, *jp["a_log"].shape) * 0.5),
              dt_bias=jnp.asarray(rand(rng, *jp["dt_bias"].shape) * 0.5),
              d_skip=jnp.asarray(rand(rng, *jp["d_skip"].shape)),
              ssd_norm={"scale": jnp.asarray(
                  rand(rng, *jp["ssd_norm"]["scale"].shape) * 0.1)})
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, tcfg, tp


def x_of(cfg, B, S, seed):
    return rand(np.random.default_rng(seed), B, S, cfg.d_model)


def test_causal_conv1d_matches_jax_with_carried_state():
    rng = np.random.default_rng(1)
    x, w, st = rand(rng, 2, 9, 12), rand(rng, 4, 12), rand(rng, 2, 3, 12)
    for state in (None, st):
        yj, sj = jlayers.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        yt, s_t = tlayers.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if state is None else torch.from_numpy(state))
        close(yt, yj, **TOL)
        close(s_t, sj, **TOL)
    # carried across calls: two halves equal one pass
    y_full, s_full = tlayers.causal_conv1d(torch.from_numpy(x),
                                           torch.from_numpy(w))
    y1, s1 = tlayers.causal_conv1d(torch.from_numpy(x[:, :4]),
                                   torch.from_numpy(w))
    y2, s2 = tlayers.causal_conv1d(torch.from_numpy(x[:, 4:]),
                                   torch.from_numpy(w), s1)
    close(torch.cat([y1, y2], 1), y_full, atol=1e-6, rtol=1e-6)
    close(s2, s_full, atol=0, rtol=0)


def test_ssd_block_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    x = x_of(tcfg, 2, 21, 2)
    close(tssm.ssd_block(tcfg, tp, torch.from_numpy(x)),
          jssm.ssd_block(jcfg, jp, jnp.asarray(x)), **TOL)


def test_ssd_block_states_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    x = x_of(tcfg, 2, 13, 3)
    rng = np.random.default_rng(3)
    d_inner, nh, dp, N = tssm.dims(tcfg)
    conv0 = rand(rng, 2, tcfg.conv_width - 1, d_inner + 2 * N)
    h0 = rand(rng, 2, nh, dp, N) * 0.3
    yj, (cj, hj) = jssm.ssd_block(jcfg, jp, jnp.asarray(x), jnp.asarray(conv0),
                                  jnp.asarray(h0), return_state=True)
    yt, (ct, ht) = tssm.ssd_block(tcfg, tp, torch.from_numpy(x),
                                  torch.from_numpy(conv0),
                                  torch.from_numpy(h0), return_state=True)
    close(yt, yj, **TOL)
    close(ct, cj, **TOL)
    close(ht, hj, **TOL)


def test_ssd_decode_step_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(4)
    d_inner, nh, dp, N = tssm.dims(tcfg)
    x = x_of(tcfg, 3, 1, 4)
    conv0 = rand(rng, 3, tcfg.conv_width - 1, d_inner + 2 * N)
    h0 = rand(rng, 3, nh, dp, N) * 0.3
    want = jssm.ssd_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(conv0),
                           jnp.asarray(h0))
    got = tssm.ssd_decode(tcfg, tp, torch.from_numpy(x),
                          torch.from_numpy(conv0), torch.from_numpy(h0))
    for g, w in zip(got, want):
        close(g, w, **TOL)


def test_ssd_decode_equals_full_sequence(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 2, 12, 5))
    y_full = tssm.ssd_block(cfg, p, x)
    conv, state = tssm.init_states(cfg, 2, "cpu")
    ys = []
    for s in range(12):
        y, conv, state = tssm.ssd_decode(cfg, p, x[:, s:s + 1], conv, state)
        ys.append(y)
    close(torch.cat(ys, 1), y_full, atol=1e-4, rtol=1e-3)


def test_ssd_state_continuation(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 1, 16, 6))
    y_full, (_, h_full) = tssm.ssd_block(cfg, p, x, return_state=True)
    y1, (c1, h1) = tssm.ssd_block(cfg, p, x[:, :8], return_state=True)
    y2, (_, h2) = tssm.ssd_block(cfg, p, x[:, 8:], c1, h1, return_state=True)
    close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-3)
    close(h2, h_full, atol=1e-4, rtol=1e-3)


def test_ssd_block_causality(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 1, 10, 7))
    x2 = x.clone()
    x2[:, 6:] = 3.0
    close(tssm.ssd_block(cfg, p, x)[:, :6], tssm.ssd_block(cfg, p, x2)[:, :6],
          atol=1e-5, rtol=0)


def test_ssd_unit_init_rules():
    cfg = tget_config("mamba2-780m", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = ttransformer.block_params(cfg, "ssd", gen)["ssd"]
    jp = jssm.ssd_params(jget_config("mamba2-780m", smoke=True),
                         jax.random.key(0))
    assert {k: tuple(np.shape(v)) for k, v in p.items() if k != "ssd_norm"} \
        == {k: tuple(v.shape) for k, v in jp.items() if k != "ssd_norm"}
    assert torch.all(p["a_log"] == 0) and torch.all(p["d_skip"] == 1)
    assert torch.all(p["dt_bias"] == 0)
    assert torch.all(p["ssd_norm"]["scale"] == 0)
    std = float(p["in_proj"].std())
    assert abs(std - np.sqrt(2.0 / cfg.d_model)) < 0.1 * std
