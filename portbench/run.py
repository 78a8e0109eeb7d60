"""The benchmark's one command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Runs one cell of ``BENCHMARK.json`` on the
card and prints the result's JSON object as the last line of standard
output (see ``portbench/README.md``)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # every cache of a run stays inside the checkout, at fixed paths
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from portbench.bench import main
    sys.exit(main())
