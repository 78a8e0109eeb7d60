"""Component ablation on the PyTorch/CUDA port (the paper's Mini / Preload
/ Cicada decomposition) on one model: which mechanism buys what.  The
twin of ``examples/ablation_components.py``: the five strategies cold
start resnet50 at full width (224x224) from one store.  Runs on the GPU;
``--device cpu`` runs the kernels' plain PyTorch versions instead, and
``--smoke`` the reduced config.

    PYTHONPATH=src python examples/torch_ablation_components.py \
        [--smoke] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import ColdStartEngine                 # noqa: E402
from repro_torch.device import resolve_device                # noqa: E402
from repro_torch.models import transformer                   # noqa: E402
from repro_torch.models.api import get_config                # noqa: E402
from repro_torch.store.store import (BandwidthModel,         # noqa: E402
                                     WeightStore, deploy_model)

STRATEGIES = ("traditional", "pisel", "mini", "preload", "cicada")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of the full width")
    ap.add_argument("--device", default=None,
                    help="the GPU by default (no GPU is an error), or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("resnet50", smoke=args.smoke)
    model = transformer.build(cfg, device=dev)
    with tempfile.TemporaryDirectory() as root:
        store = WeightStore(root, BandwidthModel(bandwidth_mbps=300,
                                                 latency_ms=0.3))
        deploy_model(store, model, "m", seed=0)
        batch = {"image": torch.as_tensor(
            np.random.default_rng(0).standard_normal(
                (1, 3, cfg.img_res, cfg.img_res)), dtype=torch.float32)}

        print(f"{cfg.name} on {dev}")
        print(f"{'strategy':12s} {'e2e ms':>8s} {'util':>6s} {'L ms':>7s} "
              f"{'R ms':>7s} {'A ms':>7s} {'mem KB':>8s}")
        traces = {}
        base = None
        for strat in STRATEGIES:
            eng = ColdStartEngine(model, "m", store, strategy=strat,
                                  device=dev)
            eng.warmup(batch)
            traces[strat] = eng.load(batch).trace
            s = traces[strat].summary()
            if strat == "pisel":
                base = s["total_s"]
            delta = "" if base is None or strat == "pisel" else \
                f"  ({1 - s['total_s'] / base:+.0%} vs pisel)"
            print(f"{strat:12s} {s['total_s'] * 1e3:8.1f} "
                  f"{s['utilization']:6.0%} {s['work_L'] * 1e3:7.1f} "
                  f"{s['work_R'] * 1e3:7.1f} {s['work_A'] * 1e3:7.1f} "
                  f"{s['mem_overhead_bytes'] / 1e3:8.1f}{delta}")
    return traces


if __name__ == "__main__":
    main()
