"""The readings that the limits of ``correct`` are set from: runs a cell
on several seeds in one process, each as a control run (the control's
numbers held to the cell's limits, so not correct, with the program's
own numbers of the same run beside them under ``readings``), and prints
one JSON line a seed with the metrics and the set-up.

    python3 portbench/tools/readings.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--trace 0|1] [--rate <r>] [--out <file>]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="an open loop's rate in place of the cell's")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    from portbench import bench, spec
    wl = spec.workload(a.workload)
    if a.rate is not None:
        wl = dict(wl, load=dict(wl["load"], rate_per_s=a.rate))
    out = open(a.out, "a") if a.out else None
    for seed in a.seeds:
        t = time.monotonic()
        res, lines = bench.run_cell(a.workload, seed, a.seconds,
                                    bool(a.trace), wl_override=wl,
                                    t_start=time.monotonic(), control=True)
        line = json.dumps({"seed": seed, "rate": a.rate,
                           "wall_s": time.monotonic() - t, **res})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    sys.exit(main())
