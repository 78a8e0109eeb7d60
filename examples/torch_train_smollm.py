"""Train smollm on the PyTorch/CUDA port for a few hundred steps, then
resume from its checkpoint (the port's twin of ``train_smollm.py``).
Runs on the GPU; ``--device cpu`` trains on the CPU with the kernels'
plain versions.

    PYTHONPATH=src python examples/torch_train_smollm.py [--full] [--device cpu]

Default trains a width-reduced SmolLM for 300 steps on the synthetic
Markov LM task (loss falls from ~ln V toward the bigram entropy floor);
--full uses the real smollm-360m config.  Demonstrates: the remat train
step (attention and rmsnorm backward kernels on the card), checkpoint +
resume, int8 error-feedback gradient compression.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.device import resolve_device                # noqa: E402
from repro_torch.launch.train import main as train_main      # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume-steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="the GPU by default (no GPU is an error), or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    ckpt = tempfile.mkdtemp(prefix="cicada-train-")
    cli = ["--arch", "smollm-360m",
           "--steps", str(args.steps), "--seq", "128", "--batch", "8",
           "--lr", "3e-3", "--ckpt-dir", ckpt,
           "--ckpt-every", str(min(100, args.steps)), "--compress-grads"]
    if args.device is not None:
        cli += ["--device", args.device]
    if not args.full:
        cli.append("--smoke")
    hist = train_main(cli)
    print(f"\ntrained {args.steps} steps; "
          f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"checkpoints in {ckpt}")
    # resume from the checkpoint for a few more steps (restart-safety demo)
    steps = cli.index("--steps") + 1
    resumed = train_main(cli[:steps] + [str(args.resume_steps)]
                         + cli[steps + 1:] + ["--resume"])
    return {"train": hist, "resumed": resumed, "ckpt": ckpt}


if __name__ == "__main__":
    main()
