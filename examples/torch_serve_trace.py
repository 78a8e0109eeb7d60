"""End-to-end serverless serving on the PyTorch/CUDA port: replay a
bursty Azure-like trace against the platform, comparing strategies
(the twin of ``examples/serve_trace.py``).  Runs on the GPU;
``--device cpu`` runs the kernels' plain PyTorch versions instead.

    PYTHONPATH=src python examples/torch_serve_trace.py [--full] [--device cpu]

--full serves the published widths; the default is the smoke config.
"""
import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import main as serve_main     # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--invocations", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the GPU by default (no GPU is an error), or 'cpu'")
    args = ap.parse_args(argv)

    store = tempfile.mkdtemp(prefix="cicada-trace-")
    common = ["--models", "smollm-360m",
              "--invocations", str(args.invocations), "--duration", "300",
              "--keep-alive", "20", "--store", store,
              "--bandwidth-mbps", "600"]
    if args.full:
        common += ["--full"]
    if args.device:
        common += ["--device", args.device]

    results = {}
    for strategy in ("pisel", "cicada"):
        print(f"\n===== strategy: {strategy} =====")
        responses = serve_main(common + ["--strategy", strategy])[strategy]
        results[strategy] = np.array([r.latency_s for r in responses])
    speedup = results["pisel"].mean() / results["cicada"].mean()
    print(f"\nmean-latency speedup cicada vs pisel: {speedup:.2f}x")
    return results


if __name__ == "__main__":
    main()
