"""The port's training path for the families beyond the dense one, against
the JAX package's, on the CPU at smoke size with f32 compute: ``LM.loss``
and every gradient leaf against ``jax.value_and_grad(model.loss)`` for
mamba2-780m (SSD blocks: ``ssd_scan``'s backward), recurrentgemma-2b
(RG-LRU blocks and attention at dh 256 smoke's 16, a tail outside remat),
mixtral-8x7b (the MoE FFN, top-2 of 8, a window, the aux loss),
arctic-480b (128-expert routing's smoke twin with a dense residual),
hubert-xlarge (frames, layernorm, GELU, non-causal attention) and
internvl2-76b (image rows ahead of the tokens): the loss within 1e-5
relative, each leaf within 1e-4 of its max |g|, the tolerances of the
dense family's test.  The JAX side runs with ``REPRO_PALLAS=ref`` (its
scans through ``_xla_ssd`` and ``_xla_rglru``); params go across with
``params_from_numpy`` and the batches as numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.training import train as ttrain
from test_torch_training import flat_jax, flat_port, make_pair

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


def family_batch(cfg, B=2, S=24, seed=2):
    """Numpy inputs of the reference's ``make_batch`` shapes: frames for
    audio (rounded to bf16, as the reference feeds them), image rows ahead
    of S - 8 tokens for the VLM, else tokens; labels (B, S) with the first
    5 of row 0 masked."""
    r = np.random.default_rng(seed)
    fam = cfg.family.value
    if fam == "audio":
        b = {"frames": r.standard_normal((B, S, cfg.frontend_dim))
             .astype(np.float32)}
    elif fam == "vlm":
        n_img = min(8, S // 2)
        b = {"tokens": r.integers(0, cfg.vocab_size, (B, S - n_img)),
             "img": r.standard_normal((B, n_img, cfg.frontend_dim))
             .astype(np.float32)}
    else:
        b = {"tokens": r.integers(0, cfg.vocab_size, (B, S))}
    lab = r.integers(0, cfg.vocab_size, (B, S))
    lab[0, :5] = -1
    b["labels"] = lab
    return b


def to_jax(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in ("frames", "img") else
                           jnp.int32) for k, v in b.items()}


def to_port(b):
    return {k: (torch.as_tensor(v).to(torch.bfloat16) if k in ("frames",
                                                                "img")
                else torch.as_tensor(v, dtype=torch.int32))
            for k, v in b.items()}


ARCHS = ["mamba2-780m", "recurrentgemma-2b", "mixtral-8x7b", "arctic-480b",
         "hubert-xlarge", "internvl2-76b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = make_pair(arch)
    b = family_batch(tm.cfg)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, to_jax(b)), has_aux=True)(jp)
    ops.registry.reset_counts()
    (tl, tmet), tg = ttrain.value_and_grad(tm, tp, to_port(b))
    assert sum(ops.registry.dispatch_snapshot().values()) == 0   # CPU
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("ce", "aux", "accuracy"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= \
            1e-5 * max(abs(float(jmet[k])), 1e-3), k
    if tm.cfg.family.value == "moe":
        assert float(tmet["aux"]) > 0
    fj, ft = flat_jax(jg), flat_port(tg)
    assert fj.keys() == ft.keys()
    moved = 0
    for n in fj:
        scale = max(np.abs(fj[n]).max(), 1e-30)
        assert np.abs(ft[n] - fj[n]).max() <= 1e-4 * scale, n
        moved += bool(np.abs(fj[n]).max() > 0)
    assert moved >= len(fj) - 2             # gradients reach the leaves


def test_donated_step_bit_equal(monkeypatch):
    """``make_train_step(donate=True)`` writes the params and moments in
    place and gives the same bits as the functional step, two steps of
    mamba2-780m smoke (bf16 compute) from the same state, its leaves
    taken in chunks of 1000 elements (so the large ones span several)."""
    from repro_torch import tree as tree_util
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    from repro_torch.training import optim
    from repro_torch.training.optim import AdamW
    monkeypatch.setattr(optim, "DONATE_CHUNK", 1000)
    model = transformer.build(get_config("mamba2-780m", smoke=True),
                              device="cpu")
    opt = AdamW(lr=1e-2)
    plain, donated = (ttrain.make_train_step(model, opt, donate=d)
                      for d in (False, True))
    p0 = model.init(0)
    pa, sa = p0, opt.init(p0)
    pb = tree_util.tree_map(torch.clone, p0)
    sb = opt.init(pb)
    leaf, moment = tree_util.leaves(pb)[0], tree_util.leaves(sb.m)[0]
    for i in range(2):
        b = to_port(family_batch(model.cfg, seed=10 + i))
        pa, sa, ma = plain(pa, sa, b)
        pb, sb, mb = donated(pb, sb, b)
        assert torch.equal(ma["loss"], mb["loss"])
    assert tree_util.leaves(pb)[0] is leaf                 # in place
    assert tree_util.leaves(sb.m)[0] is moment
    assert not torch.equal(tree_util.leaves(p0)[0], leaf)
    for x, y in zip(tree_util.leaves((pa, sa.m, sa.v)),
                    tree_util.leaves((pb, sb.m, sb.v))):
        assert torch.equal(x, y)
    assert int(sb.step) == 2
    assert max(t.numel() for t in tree_util.leaves(pb)) > 3000


def test_gradients_free_without_the_garbage_collector():
    """A step's gradients die with their last reference: no reference
    cycle (``tree.unflatten`` once held one) keeps them until the
    collector runs, beside the next step's (11 GiB at internvl2's 1 layer
    on the card).  The first call of a process is left out: one-time
    set-up may hold it."""
    import gc
    import weakref
    from repro_torch import tree as tree_util
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    model = transformer.build(get_config("internvl2-76b", smoke=True),
                              device="cpu")
    params = model.init(0)
    b = to_port(family_batch(model.cfg))
    ttrain.value_and_grad(model, params, b)
    gc.disable()
    try:
        for remat in (True, False):
            (loss, met), g = ttrain.value_and_grad(model, params, b,
                                                   remat=remat)
            refs = [weakref.ref(t) for t in tree_util.leaves(g)]
            del g, loss, met
            assert all(r() is None for r in refs), remat
    finally:
        gc.enable()
