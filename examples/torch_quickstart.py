"""Quickstart on the PyTorch/CUDA port: deploy a model, cold-start it
through the Cicada pipeline, inspect the Gantt chart, then serve warm
requests.  Runs on the GPU; ``--device cpu`` runs the kernels' plain
PyTorch versions instead.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the GPU by default (no GPU is an error), or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. pick an architecture (any LM id of list_archs(), or the paper's
    #    own resnet50 / vgg16 / vit_b_16) — smoke size
    cfg = get_config("smollm-360m", smoke=True)
    model = transformer.build(cfg, device=dev)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.2f}M params, "
          f"{cfg.n_layers} layers -> {len(model.unit_names())} pipeline "
          f"units) on {dev}")

    # 2. publish it to a weight store (one extent per pipeline unit);
    #    the BandwidthModel simulates a cloud NVMe device
    store = WeightStore(tempfile.mkdtemp(),
                        BandwidthModel(bandwidth_mbps=400, latency_ms=0.2))
    deploy_model(store, model, "demo", seed=0)
    print(f"deployed: {store.model_nbytes('demo') / 1e6:.1f} MB across "
          f"{len(store.manifest('demo')['units'])} extents")

    # 3. a request arrives -> cold start through the Cicada pipeline
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16)))}
    engine = ColdStartEngine(model, "demo", store, strategy="cicada",
                             device=dev)
    engine.warmup(batch)                 # deploy-time kernel build + warmup
    result = engine.load(batch)

    print(f"\ncold start ({result.strategy}): "
          f"{result.trace.total_time() * 1e3:.1f} ms, "
          f"utilization {result.trace.utilization():.0%}")
    print(result.trace.render_gantt(80))

    # 4. compare against the PISeL baseline
    pisel = ColdStartEngine(model, "demo", store, strategy="pisel",
                            device=dev)
    pisel.warmup(batch)
    base = pisel.load(batch)
    print(f"\npisel baseline: {base.trace.total_time() * 1e3:.1f} ms, "
          f"utilization {base.trace.utilization():.0%}")
    print(base.trace.render_gantt(80))
    speedup = base.trace.total_time() / result.trace.total_time()
    print(f"\ncicada speedup vs pisel: {speedup:.2f}x")

    # 5. the assembled params serve warm requests directly
    with torch.no_grad():
        logits, _ = model.forward(result.params,
                                  {k: v.to(dev) for k, v in batch.items()})
    same = torch.allclose(logits.float(), result.logits.float(), atol=1e-4)
    print(f"warm forward matches in-pipeline logits: {same}")
    return {"cicada": result, "pisel": base, "warm_matches": same}


if __name__ == "__main__":
    main()
