"""The port's Griffin RG-LRU block against ``repro.models.griffin`` on the
same params and inputs (recurrentgemma-2b smoke, f32 compute,
``REPRO_PALLAS=ref``), within 1e-4: the gates (computed with ``expm1`` as
the reference does, and bounded), the block with and without its states,
one decode step; and, mirroring ``tests/test_ssm_griffin.py``, decode
against the full sequence, state continuation and causality; and the
reference's init rules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import griffin as jgriffin
from repro.models.api import get_config as jget_config
from repro_torch.models import griffin as tgriffin
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
    jcfg = dataclasses.replace(jget_config("recurrentgemma-2b", smoke=True),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config("recurrentgemma-2b", smoke=True),
                               compute_dtype=torch.float32)
    jp = jgriffin.rglru_params(jcfg, jax.random.key(0))
    # non-trivial gates: the init's zeros would hide a wrong wa/ba/wi/bi
    rng = np.random.default_rng(0)
    jp = dict(jp, **{k: jnp.asarray(rand(rng, *jp[k].shape) * 0.5)
                     for k in ("wa", "ba", "wi", "bi", "lam")})
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, tcfg, tp


def x_of(cfg, B, S, seed):
    return rand(np.random.default_rng(seed), B, S, cfg.d_model)


def test_gates_match_jax_and_are_bounded(pair):
    _, jp, tcfg, tp = pair
    px = rand(np.random.default_rng(1), 2, 20, tcfg.rglru_width) * 5
    aj, bj = jgriffin._gates(jp, jnp.asarray(px))
    at, bt = tgriffin._gates(tp, torch.from_numpy(px))
    close(at, aj, atol=1e-6, rtol=1e-6)
    close(bt, bj, atol=1e-5, rtol=1e-5)
    assert bool(((at > 0) & (at < 1)).all()) and bool(torch.isfinite(bt).all())


def test_rglru_block_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    x = x_of(tcfg, 2, 19, 2)
    close(tgriffin.rglru_block(tcfg, tp, torch.from_numpy(x)),
          jgriffin.rglru_block(jcfg, jp, jnp.asarray(x)), **TOL)


def test_rglru_block_states_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    x = x_of(tcfg, 2, 11, 3)
    rng = np.random.default_rng(3)
    w = tcfg.rglru_width
    conv0 = rand(rng, 2, tcfg.conv_width - 1, w)
    h0 = rand(rng, 2, w)
    yj, (cj, hj) = jgriffin.rglru_block(jcfg, jp, jnp.asarray(x),
                                        jnp.asarray(conv0), jnp.asarray(h0),
                                        return_state=True)
    yt, (ct, ht) = tgriffin.rglru_block(tcfg, tp, torch.from_numpy(x),
                                        torch.from_numpy(conv0),
                                        torch.from_numpy(h0),
                                        return_state=True)
    close(yt, yj, **TOL)
    close(ct, cj, **TOL)
    close(ht, hj, **TOL)


def test_rglru_decode_step_matches_jax(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(4)
    w = tcfg.rglru_width
    x = x_of(tcfg, 3, 1, 4)
    conv0, h0 = rand(rng, 3, tcfg.conv_width - 1, w), rand(rng, 3, w)
    want = jgriffin.rglru_decode(jcfg, jp, jnp.asarray(x), jnp.asarray(conv0),
                                 jnp.asarray(h0))
    got = tgriffin.rglru_decode(tcfg, tp, torch.from_numpy(x),
                                torch.from_numpy(conv0), torch.from_numpy(h0))
    for g, w_ in zip(got, want):
        close(g, w_, **TOL)


def test_rglru_decode_equals_full_sequence(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 2, 10, 5))
    y_full = tgriffin.rglru_block(cfg, p, x)
    conv, h = tgriffin.init_states(cfg, 2, "cpu")
    ys = []
    for s in range(10):
        y, conv, h = tgriffin.rglru_decode(cfg, p, x[:, s:s + 1], conv, h)
        ys.append(y)
    close(torch.cat(ys, 1), y_full, atol=1e-4, rtol=1e-3)


def test_rglru_state_continuation(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 1, 16, 6))
    y_full, (_, h_full) = tgriffin.rglru_block(cfg, p, x, return_state=True)
    y1, (c1, h1) = tgriffin.rglru_block(cfg, p, x[:, :7], return_state=True)
    y2, (_, h2) = tgriffin.rglru_block(cfg, p, x[:, 7:], c1, h1,
                                       return_state=True)
    close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-3)
    close(h2, h_full, atol=1e-5, rtol=1e-5)


def test_rglru_block_causality(pair):
    _, _, cfg, p = pair
    x = torch.from_numpy(x_of(cfg, 1, 12, 7))
    x2 = x.clone()
    x2[:, 8:] = -2.0
    close(tgriffin.rglru_block(cfg, p, x)[:, :8],
          tgriffin.rglru_block(cfg, p, x2)[:, :8], atol=1e-5, rtol=0)


def test_rglru_unit_init_rules():
    cfg = tget_config("recurrentgemma-2b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = ttransformer.block_params(cfg, "rglru", gen)
    jp = jgriffin.rglru_params(jget_config("recurrentgemma-2b", smoke=True),
                               jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in p["rglru"].items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert sorted(p) == ["mlp", "norm1", "norm2", "rglru"]
    for k in ("wa", "ba", "wi", "bi"):
        assert torch.all(p["rglru"][k] == 0)
    assert torch.all(p["rglru"]["lam"] == 0.65)
