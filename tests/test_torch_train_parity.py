"""The recurrent families' training at the launcher's settings, the port
against the JAX package on the CPU: mamba2-780m and recurrentgemma-2b
smoke at f32 compute, from the same params (``params_from_numpy``) and
the same ``MarkovLM`` batches (``host_batches``), through both packages'
``make_train_step`` with ``launch/train.py``'s optimiser: AdamW at the
default ``--lr 3e-3`` on its ``warmup_cosine`` schedule (warm-up over a
tenth of the steps), weight decay 0.01.  Ten steps at seq 32, batch 2:
every step's loss within 1e-4 of the reference's, relative, and the
gradient norm within 1e-2.  The two are the same training, so a flat
loss at 3e-3 is the setting's, not the port's.  The JAX side runs with
``REPRO_PALLAS=ref``."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.training import data as jdata
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch.training import data as tdata
from repro_torch.training import optim as toptim
from repro_torch.training import train as ttrain
from test_torch_training import make_pair

torch.set_num_threads(2)
STEPS, SEQ, BATCH, LR = 10, 32, 2, 3e-3
# f32 on both sides; the scans and their gradients sum in other orders,
# so each step moves by f32 rounding, carried through ten AdamW updates.
# AdamW scales each coordinate's step to about lr whatever its gradient,
# so coordinates whose gradients are near zero differ by up to lr after
# an update: the gradient norm shows it before the loss does (from the
# same params the gradients agree: test_torch_training_families.py)
LOSS_TOL, NORM_TOL = 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "ref")


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_losses_track_jax_at_the_launchers_lr(arch):
    jm, jp, tm, tp = make_pair(arch)
    jopt = joptim.AdamW(lr=joptim.warmup_cosine(LR, STEPS // 10, STEPS),
                        weight_decay=0.01)
    topt = toptim.AdamW(lr=toptim.warmup_cosine(LR, STEPS // 10, STEPS),
                        weight_decay=0.01)
    jstep = jax.jit(jtrain.make_train_step(jm, jopt))
    tstep = ttrain.make_train_step(tm, topt)
    js, ts = jopt.init(jp), topt.init(tp)
    jb = jdata.host_batches(jdata.MarkovLM(jm.cfg.vocab_size, seed=0),
                            global_batch=BATCH, seq=SEQ)
    tb = tdata.host_batches(tdata.MarkovLM(tm.cfg.vocab_size, seed=0),
                            global_batch=BATCH, seq=SEQ)
    losses = []
    for _ in range(STEPS):
        b = next(tb)
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v)
                                      for k, v in next(jb).items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.as_tensor(v)
                                      for k, v in b.items()})
        want, got = float(jmet["loss"]), float(tmet["loss"])
        losses.append((want, got))
        assert abs(got - want) <= LOSS_TOL * abs(want), (len(losses),
                                                         losses)
        jn, tn = float(jmet["grad_norm"]), float(tmet["grad_norm"])
        assert abs(tn - jn) <= NORM_TOL * jn, (len(losses), tn, jn)
    assert int(ts.step) == STEPS
