"""The port's training path against the JAX package's, on the CPU at smoke
size with f32 compute: the Markov batches bit-equal; ``warmup_cosine``
and ``AdamW.update`` on the same tree and gradients within 1e-6;
``LM.loss`` and every gradient leaf against ``jax.value_and_grad(
model.loss)`` for smollm-360m (dh 20) and h2o-danube-3-4b (a window):
the loss within 1e-5 relative, each leaf within 1e-4 of its max |g|;
3-step loss trajectories through both packages' ``make_train_step``
(plain, ``micro_batches=2``, ``mixed_precision``); every assigned arch
trains (none is refused); the serving forward carries no gradient and
remat changes no bit.  The JAX side runs with
``REPRO_PALLAS=ref``; params go across with ``params_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models.api import get_config as jget_config
from repro.training import data as jdata
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import get_config as tget_config
from repro_torch.training import data as tdata
from repro_torch.training import optim as toptim
from repro_torch.training import train as ttrain

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def make_pair(arch, **over):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               compute_dtype=torch.float32, **over)
    jm = jtransformer.build(jcfg)
    jparams = jm.init(jax.random.key(0))
    tm = ttransformer.build(tcfg, device="cpu")
    tparams = ttransformer.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


def flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree):
    return {"/".join(p): v.detach().float().numpy()
            for p, v in tree_util.leaves_with_path(tree)}


def batches(cfg, n, B=4, S=16, seed=1):
    gen = tdata.MarkovLM(cfg.vocab_size, seed=seed)
    return [gen.batch(B, S, i) for i in range(n)]


def test_markov_batches_bit_equal():
    for vocab, seed in ((512, 0), (256, 3), (49152, 1)):
        j, t = jdata.MarkovLM(vocab, seed=seed), tdata.MarkovLM(vocab,
                                                               seed=seed)
        np.testing.assert_array_equal(j.succ, t.succ)
        for step in (0, 5, 1234):
            jb, tb = j.batch(4, 16, step), t.batch(4, 16, step)
            for k in ("tokens", "labels"):
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        assert j.bigram_ce_floor() == t.bigram_ce_floor()
        for host in (0, 1):
            jh = next(jdata.host_batches(j, global_batch=8, seq=16,
                                         host_id=host, n_hosts=2,
                                         start_step=7))
            th = next(tdata.host_batches(t, global_batch=8, seq=16,
                                         host_id=host, n_hosts=2,
                                         start_step=7))
            np.testing.assert_array_equal(jh["tokens"], th["tokens"])


def test_warmup_cosine_matches():
    js = joptim.warmup_cosine(3e-3, 20, 200)
    ts = toptim.warmup_cosine(3e-3, 20, 200)
    for s in (0, 1, 10, 19, 20, 21, 100, 199, 200, 250):
        want = float(js(jnp.asarray(s, jnp.int32)))
        got = float(ts(torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3), (s, got, want)


def test_adamw_update_matches():
    """Two updates on the same tree and gradients (clipped: the norm is
    above 1): params, m, v, step, grad norm and lr within 1e-6.  The
    stacked norm scales ``s0`` (2-D) decay, the tail's (1-D) do not."""
    r = np.random.default_rng(0)
    tree = {"blocks": {"s0": {"norm1": {"scale": r.standard_normal((3, 8))},
                              "attn": {"wq": r.standard_normal((3, 8, 2, 4))}},
                       "t0": {"norm1": {"scale": r.standard_normal(8)}}},
            "embed": {"tok": r.standard_normal((16, 8))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: (r.standard_normal(a.shape) * 3)
                          .astype(np.float32), tree) for _ in range(2)]
    jopt = joptim.AdamW(lr=joptim.warmup_cosine(1e-2, 1, 10),
                        weight_decay=0.1)
    topt = toptim.AdamW(lr=toptim.warmup_cosine(1e-2, 1, 10),
                        weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tree_util.tree_map(torch.from_numpy, tree)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.step.dtype == torch.int32 and ts.m["embed"]["tok"].dtype == \
        torch.float32
    for g in grads:
        jp, js, jm_ = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm_ = topt.update(tree_util.tree_map(torch.from_numpy, g),
                                  ts, tp)
        assert float(jm_["grad_norm"]) > 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm_[k]) - float(jm_[k])) <= \
                1e-6 * abs(float(jm_[k]))
        for a, b in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            fa, fb = flat_jax(a), flat_port(b)
            assert fa.keys() == fb.keys()
            for n in fa:
                np.testing.assert_allclose(fb[n], fa[n], atol=1e-6,
                                           rtol=1e-6, err_msg=n)
        assert int(ts.step) == int(js.step)
    # decay on the stacked (3, 8) scales, none on the tail's (8,)
    zero = tree_util.tree_map(torch.zeros_like, tp)
    moved, _, _ = toptim.AdamW(lr=1e-1, weight_decay=0.5).update(
        zero, toptim.AdamW().init(tp), tp)
    assert not torch.equal(moved["blocks"]["s0"]["norm1"]["scale"],
                           tp["blocks"]["s0"]["norm1"]["scale"])
    assert torch.equal(moved["blocks"]["t0"]["norm1"]["scale"],
                       tp["blocks"]["t0"]["norm1"]["scale"])


@pytest.mark.parametrize("arch", ["smollm-360m", "h2o-danube-3-4b"])
def test_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = make_pair(arch)
    r = np.random.default_rng(2)
    tok = r.integers(0, tm.cfg.vocab_size, (2, 24))
    lab = r.integers(0, tm.cfg.vocab_size, (2, 24))
    lab[0, :5] = -1                                    # masked labels
    if arch == "h2o-danube-3-4b":
        assert tm.cfg.sliding_window and tm.cfg.sliding_window < 24
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(lab, jnp.int32)}
    tb = {"tokens": torch.as_tensor(tok, dtype=torch.int32),
          "labels": torch.as_tensor(lab, dtype=torch.int32)}
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    ops.registry.reset_counts()
    (tl, tmet), tg = ttrain.value_and_grad(tm, tp, tb)
    assert sum(ops.registry.dispatch_snapshot().values()) == 0   # CPU
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("ce", "aux", "accuracy"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            1e-5 * max(abs(float(jmet[k])), 1e-3), k
    fj, ft = flat_jax(jg), flat_port(tg)
    assert fj.keys() == ft.keys()
    for n in fj:
        scale = max(np.abs(fj[n]).max(), 1e-30)
        assert np.abs(ft[n] - fj[n]).max() <= 1e-4 * scale, n


# (name, make_train_step options, loss tolerance relative to the loss)
TRAJ = [("plain", {}, 1e-5), ("micro2", {"micro_batches": 2}, 1e-5),
        ("mixed", {"mixed_precision": True}, 2e-3)]


@pytest.mark.parametrize("name,opts,tol", TRAJ, ids=[t[0] for t in TRAJ])
def test_trajectory_matches_jax(name, opts, tol):
    """3 steps from the same params and batches: each step's loss within
    ``tol`` of the reference's (1e-5 in f32; 2e-3 with bf16 params, whose
    gradients round to bf16 where the two packages' f32 sums differ in
    their last bits).  ``micro_batches=2`` also against the plain step."""
    jm, jp, tm, tp = make_pair("smollm-360m")
    jopt, topt = joptim.AdamW(lr=1e-2), toptim.AdamW(lr=1e-2)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt, **opts))
    tstep = ttrain.make_train_step(tm, topt, **opts)
    js, ts = jopt.init(jp), topt.init(tp)
    for b in batches(tm.cfg, 3):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                      b.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.as_tensor(v) for k, v in
                                      b.items()})
        want, got = float(jmet["loss"]), float(tmet["loss"])
        assert abs(got - want) <= tol * abs(want), (name, got, want)
        assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) \
            <= 100 * tol * float(jmet["grad_norm"])
    assert ts.step.item() == 3


def test_refused_families_raise():
    """No family is refused any more: every assigned arch, each family's
    smoke config, gives a finite loss and a gradient to every leaf that
    ``LM.loss`` reaches (the families the port once refused, ROADMAP item
    [17], among them), and the model has no refusal left to call."""
    from repro_torch.configs import ASSIGNED
    from test_torch_training_families import family_batch
    for arch in ASSIGNED:
        m = ttransformer.build(tget_config(arch, smoke=True), device="cpu")
        assert not hasattr(m, "check_trainable")
        b = {k: torch.as_tensor(v) for k, v in
             family_batch(m.cfg, B=1, S=12).items()}
        (loss, _), g = ttrain.value_and_grad(m, m.init(0), b)
        assert torch.isfinite(loss), arch
        assert all(torch.isfinite(t.float()).all() for t in
                   tree_util.leaves(g)), arch


def test_serving_forward_carries_no_gradient():
    """``forward`` stays under no_grad even on params that want one, and
    remat changes no bit of the loss or the gradients."""
    _, _, tm, tp = make_pair("smollm-360m")
    req = tree_util.tree_map(lambda t: t.detach().requires_grad_(), tp)
    tok = torch.as_tensor(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 12)))
    logits, _ = tm.forward(req, {"tokens": tok})
    assert not logits.requires_grad
    b = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    (l1, _), g1 = ttrain.value_and_grad(tm, tp, b, remat=True)
    (l2, _), g2 = ttrain.value_and_grad(tm, tp, b, remat=False)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, c) for a, c in zip(tree_util.leaves(g1),
                                                 tree_util.leaves(g2)))
    with torch.no_grad():
        assert torch.equal(tm.forward(tp, {"tokens": tok})[0], logits)
