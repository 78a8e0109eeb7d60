"""The port's MoE FFN (``repro_torch.models.moe``) and ``quant.expert_einsum``
against the JAX package's on the same seeded numpy inputs, at f32 compute
on the smoke configs: the six properties of ``tests/test_moe.py`` on the
port; ``route``, ``capacity``, ``moe_block`` and ``moe_block_dense_ref``
within 1e-5 of max |y| of the reference's, also where capacity drops
tokens; both selections break exact ties by the lower index, as
``jax.lax.top_k`` does; the combine is bit-equal across runs; and an
int8-resident ``expert_einsum`` equals the reference's.  The JAX side runs
with ``REPRO_PALLAS=ref``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.models import moe as jmoe
from repro.models.api import get_config as jget_config
from repro_torch import quant as tquant
from repro_torch.models import moe as tmoe
from repro_torch.models.api import get_config as tget_config

torch.set_num_threads(2)
BLOCK_TOL = 1e-5          # of max |y|


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def cfgs(arch="mixtral-8x7b", **kw):
    """The smoke config at f32 compute in both packages."""
    j = dataclasses.replace(jget_config(arch, smoke=True),
                            compute_dtype=jnp.float32, **kw)
    t = dataclasses.replace(tget_config(arch, smoke=True),
                            compute_dtype=torch.float32, **kw)
    return j, t


def params(jcfg, seed=0):
    """The reference's ``moe_params``, and the same values as tensors."""
    jp = jmoe.moe_params(jcfg, jax.random.key(seed))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def tmoe_params(cfg, seed):
    """The port's own init of one MoE FFN (``BlockUnit``'s layout)."""
    gen = torch.Generator().manual_seed(seed)
    shapes = tmoe.moe_shapes(cfg)

    def alloc(s):
        return ({k: alloc(v) for k, v in s.items()} if isinstance(s, dict)
                else torch.empty(s))
    p = alloc(shapes)
    tmoe.moe_init_(cfg, p, gen)
    return p


def xs(cfg, B=2, S=16, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def within(got, want, tol=BLOCK_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


# ---------------------------------------------------------------------------
# the reference's properties (tests/test_moe.py), on the port
# ---------------------------------------------------------------------------

def test_no_drop_matches_dense_reference():
    """With capacity >= S the gather dispatch equals compute-all-experts."""
    _, cfg = cfgs(capacity_factor=float(4 / 2 * 2))      # C = S
    p = tmoe_params(cfg, 0)
    x = xs(cfg)[1]
    y, aux = tmoe.moe_block(cfg, p, x)
    torch.testing.assert_close(y, tmoe.moe_block_dense_ref(cfg, p, x),
                               atol=1e-4, rtol=1e-4)
    assert aux.dtype == torch.float32 and aux.dim() == 0


def test_routing_weights_normalized():
    _, cfg = cfgs()
    w_te, probs, mask = tmoe.route(cfg, tmoe_params(cfg, 1)["router"],
                                   xs(cfg)[1])
    w = w_te.numpy()
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal((w > 0).sum(-1),
                                  np.full(w.shape[:2], cfg.top_k))
    np.testing.assert_array_equal(mask.numpy(), (w > 0).astype(np.float32))
    np.testing.assert_allclose(probs.numpy().sum(-1), 1.0, atol=1e-5)


def test_capacity_bounds_tokens_per_expert():
    """At most C tokens per (row, expert) contribute, over several seeds
    (the reference draws them with hypothesis)."""
    _, cfg = cfgs(capacity_factor=1.0)
    for seed in (0, 7, 513, 1024):
        x = xs(cfg, seed=seed)[1]
        S = x.shape[1]
        C = tmoe.capacity(cfg, S)
        w_te, _, _ = tmoe.route(cfg, tmoe_params(cfg, seed)["router"], x)
        g, idx = tmoe.top_k(w_te.transpose(1, 2), C)
        assert g.shape[-1] == C <= S
        # one expert's C tokens of a row are distinct
        assert all(len(set(r.tolist())) == C for r in idx.reshape(-1, C))


def test_load_balance_loss_uniform_is_one():
    """Perfectly uniform routing gives loss == k (per-token k experts)."""
    E, B, S, k = 8, 4, 64, 2
    probs = torch.full((B, S, E), 1.0 / E)
    mask = torch.zeros((B, S, E))
    mask[..., :k] = 1.0
    mask = torch.stack([torch.roll(mask[b], b, dims=-1) for b in range(B)])
    assert abs(float(tmoe.load_balance_loss(probs, mask, E)) - k) < 1e-5


def test_dense_residual_arctic():
    _, cfg = cfgs("arctic-480b")
    assert cfg.dense_residual
    p = tmoe_params(cfg, 0)
    assert "dense" in p
    x = xs(cfg)[1]
    y, _ = tmoe.moe_block(cfg, p, x)
    p2 = dict(p, dense={k: torch.zeros_like(v)
                        for k, v in p["dense"].items()})
    y2, _ = tmoe.moe_block(cfg, p2, x)
    assert (y - y2).abs().max() > 1e-4


def test_decode_single_token_routing():
    """S=1 (decode): every token is served, no drops possible."""
    _, cfg = cfgs(capacity_factor=1.0)
    p = tmoe_params(cfg, 2)
    x = xs(cfg, B=4, S=1)[1]
    assert tmoe.capacity(cfg, 1) == 1
    y, _ = tmoe.moe_block(cfg, p, x)
    torch.testing.assert_close(y, tmoe.moe_block_dense_ref(cfg, p, x),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# against the reference, on the same inputs
# ---------------------------------------------------------------------------

def test_route_and_capacity_match_jax():
    for arch in ("mixtral-8x7b", "arctic-480b"):
        jcfg, tcfg = cfgs(arch)
        for S in (1, 5, 16, 33):
            assert tmoe.capacity(tcfg, S) == jmoe.capacity(jcfg, S)
        jp, tp = params(jcfg, 3)
        jx, tx = xs(tcfg, seed=3)
        for got, want in zip(tmoe.route(tcfg, tp["router"], tx),
                             jmoe.route(jcfg, jp["router"], jx)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {}),
    ("mixtral-8x7b", {"capacity_factor": 0.5}),
    ("arctic-480b", {"capacity_factor": 1.0}),
], ids=["mixtral", "mixtral-drops", "arctic-drops"])
def test_moe_block_matches_jax(arch, kw):
    """``moe_block`` (its aux loss too) and the dense oracle within 1e-5
    of max |y|; with ``capacity_factor`` below what S needs, tokens drop
    (the dispatch differs from the dense oracle) and still agree."""
    jcfg, tcfg = cfgs(arch, **kw)
    jp, tp = params(jcfg, 4)
    jx, tx = xs(tcfg, B=3, S=24, seed=4)
    jy, jaux = jmoe.moe_block(jcfg, jp, jx)
    ty, taux = tmoe.moe_block(tcfg, tp, tx)
    within(ty, jy)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    jd = jmoe.moe_block_dense_ref(jcfg, jp, jx)
    within(tmoe.moe_block_dense_ref(tcfg, tp, tx), jd)
    dropped = np.abs(np.asarray(jy) - np.asarray(jd)).max() > 1e-3
    assert dropped == bool(kw), "the drop case must drop tokens"


def test_top_k_breaks_exact_ties_as_jax():
    """Equal values come out lower index first, as ``jax.lax.top_k``
    gives them: on values drawn from a three-value set, and through a
    whole block whose router is zero (every token's probabilities tie,
    so experts 0 and 1 take every token and the per-expert token
    selections tie in bulk)."""
    vals = np.random.default_rng(5).choice(
        np.array([0.0, 0.25, 0.5], np.float32), size=(3, 4, 40))
    for k in (1, 2, 7, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(vals), k)
        tv, ti = tmoe.top_k(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcfg, tcfg = cfgs(capacity_factor=1.0)
    jp, tp = params(jcfg, 6)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = xs(tcfg, seed=6)
    w_te, _, _ = tmoe.route(tcfg, tp["router"], tx)
    assert (w_te[..., :2] == 0.5).all() and (w_te[..., 2:] == 0).all()
    C = tmoe.capacity(tcfg, tx.shape[1])
    _, ti = tmoe.top_k(w_te.transpose(1, 2), C)
    _, ji = jax.lax.top_k(jnp.swapaxes(jmoe.route(jcfg, jp["router"],
                                                  jx)[0], 1, 2), C)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti == torch.arange(C)).all()
    within(tmoe.moe_block(tcfg, tp, tx)[0], jmoe.moe_block(jcfg, jp, jx)[0])


def test_combine_is_bit_equal_across_runs():
    """Two runs of a block give the same bits (the combine adds the
    experts in index order with plain writes), and agree with JAX."""
    jcfg, tcfg = cfgs(capacity_factor=1.0)
    jp, tp = params(jcfg, 7)
    jx, tx = xs(tcfg, B=2, S=32, seed=7)
    a, _ = tmoe.moe_block(tcfg, tp, tx)
    b, _ = tmoe.moe_block(tcfg, tp, tx.clone())
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    within(a, jmoe.moe_block(jcfg, jp, jx)[0])


def test_expert_einsum_matches_jax():
    """An int8-resident expert leaf (E, k, n) with one scale over n:
    one product per expert, in both forms, against
    ``repro.quant.expert_einsum``; a plain leaf likewise."""
    rng = np.random.default_rng(8)
    E, B, C, k, n = 4, 2, 5, 24, 40
    q = rng.integers(-127, 128, (E, k, n)).astype(np.int8)
    s = (np.abs(rng.standard_normal(n)) * 0.02 + 1e-3).astype(np.float32)
    jw = jquant.QuantLeaf(jnp.asarray(q), jnp.asarray(s))
    tw = tquant.QuantLeaf(torch.from_numpy(q), torch.from_numpy(s))
    x = rng.standard_normal((B, E, C, k)).astype(np.float32)
    xsh = rng.standard_normal((B, C, k)).astype(np.float32)
    f32 = (jnp.float32, torch.float32)
    cases = [("becd,edf->becf", x, False), ("bsd,edf->besf", xsh, True)]
    for eq, xv, shared in cases:
        want = jquant.expert_einsum(eq, jnp.asarray(xv), jw, f32[0],
                                    shared_x=shared)
        got = tquant.expert_einsum(torch.from_numpy(xv), tw, f32[1],
                                   shared_x=shared)
        assert tuple(got.shape) == (B, E, C, n)
        within(got, want)
        wf = q.astype(np.float32) * s
        want = jquant.expert_einsum(eq, jnp.asarray(xv), jnp.asarray(wf),
                                    f32[0], shared_x=shared)
        within(tquant.expert_einsum(torch.from_numpy(xv),
                                    torch.from_numpy(wf), f32[1],
                                    shared_x=shared), want)
