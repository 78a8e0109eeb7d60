"""Training launcher: ``python -m repro_torch.launch.train --arch
smollm-360m`` (the port of ``repro.launch.train``).

Drives the full stack on the card (or ``--device cpu``): mesh
construction, param init, the train step (remat + optional int8
error-feedback gradient compression), Markov data pipeline, atomic
checkpointing with resume, preemption-safe loop.  The same flags as the
reference, plus ``--device``.  ``--production-mesh`` asks for the
reference's 16 x 16 pod mesh, and raises when the process has fewer
devices, as ``jax.make_mesh`` does.
"""
from __future__ import annotations

import argparse
import types

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.compression import (init_error_feedback,
                                                 make_error_feedback_transform)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.api import get_config
from repro_torch.training.data import MarkovLM, host_batches
from repro_torch.training.optim import AdamW, AdamWState, warmup_cosine
from repro_torch.training.train import TrainLoop, make_train_step, \
    value_and_grad


def production_mesh(dev: torch.device):
    """The reference's pod mesh, refused when this process lacks its
    devices."""
    mesh = make_production_mesh()
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    if mesh.size > have:
        raise ValueError(f"the production mesh {mesh.shape} needs "
                         f"{mesh.size} devices, this process has {have}")
    return mesh


def main(argv=None, *, log_every: int = 10):
    """Train as the flags say; returns the loop's history.  ``log_every``:
    the steps between logged (and recorded) losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    model = transformer.build(cfg, device=dev)
    model.check_trainable()
    mesh = (production_mesh(dev) if args.production_mesh
            else make_local_mesh(args.model_parallel, device=dev))
    rules = shd.train_rules()
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"mesh={dict(mesh.shape)} device={dev}")

    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps),
                weight_decay=0.01)

    with shd.use_rules(mesh, rules):
        params = model.init(args.seed)
        opt_state = opt.init(params)

        ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
        start_step = 0
        if ckpt and args.resume and ckpt.latest_step() is not None:
            params_ab = model.abstract()
            start_step, params, opt_state = ckpt.restore(
                params_ab, AdamWState(None, params_ab, params_ab),
                device=dev)
            print(f"resumed from step {start_step}")

        if args.compress_grads:
            # the error-feedback residual is carried state, folded into
            # the opt_state slot; it is deliberately NOT part of the
            # checkpoint (soft state — a restart loses one step's
            # residual, which error feedback re-absorbs)
            ef_transform = make_error_feedback_transform()

            def step_fn(params, state, batch):
                adam_state, ef = state
                (loss, metrics), grads = value_and_grad(model, params, batch)
                grads, ef = ef_transform(grads, ef)
                params, adam_state, om = opt.update(grads, adam_state,
                                                    params)
                metrics = dict(metrics)
                metrics.update(om)
                metrics["loss"] = loss
                return params, (adam_state, ef), metrics

            opt_state = (opt_state, init_error_feedback(params))
            if ckpt is not None:
                inner = ckpt

                def save(step, params, state):
                    return inner.save(step, params, state[0])
                ckpt = types.SimpleNamespace(save=save,
                                             latest_step=inner.latest_step)
        else:
            step_fn = make_train_step(model, opt)
        data = MarkovLM(cfg.vocab_size, seed=args.seed)
        batches = host_batches(data, global_batch=args.batch, seq=args.seq,
                               start_step=start_step)
        loop = TrainLoop(model, opt, step_fn=step_fn, checkpointer=ckpt,
                         ckpt_every=args.ckpt_every, log_every=log_every)
        loop.install_signal_handler()
        try:
            params, opt_state, hist = loop.run(
                params, opt_state, batches, start_step=start_step,
                n_steps=args.steps)
        finally:
            loop.restore_signal_handlers()
        print(f"final loss {hist['loss'][-1]:.4f} "
              f"(bigram floor ~{data.bigram_ce_floor():.3f})")
        return hist


if __name__ == "__main__":
    main()
