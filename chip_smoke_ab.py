#!/usr/bin/env python3
"""Phase 26 of ``chip_smoke.py`` (shard-granular cold starts on a logical
(1, 4) mesh of the card) from several checkouts in one run, against
stores deployed once, so that commits compare on the same card:

    python3 chip_smoke_ab.py PARENT CHANGE CHANGE PARENT

Each argument is the root of a checkout that has ``chip_smoke.py`` with
``sharded_cold_starts`` (for example another commit's ``git archive``,
unpacked).  The runs go in the order given, each in a process of its own
that builds that checkout's kernels and runs its phase 26: its loads on
one device and on the mesh, their I/O floors, R and T ms by shard, and
its other checks.  The stores are phase 4's smollm-360m stores (f32 and
int8) and phase 20's int8 mixtral-8x7b store at ``MIXTRAL_LAYERS``,
deployed by this checkout's ``chip_smoke.py`` into a temporary directory.
Needs one card; exits non-zero if a run fails.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

RUN = """
import sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from repro_torch.kernels import ops
t0 = time.perf_counter()
ops.registry.build()
t1 = time.perf_counter()
cs.sharded_cold_starts(torch.device("cuda", 0), sys.argv[1])
print(f"phase 26 passed in {time.perf_counter() - t1:.1f} s (build "
      f"{t1 - t0:.1f} s)")
"""


def main(argv) -> int:
    import torch
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke_ab: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(a) for a in argv]
    for root in roots:
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"chip_smoke_ab: no chip_smoke.py in {root}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from repro_torch.models import transformer
    from repro_torch.models.api import get_config
    print(cs.card_line())
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as wd:
        t0 = time.perf_counter()
        cs.deploy_smollm(wd)
        mcfg = dataclasses.replace(get_config("mixtral-8x7b"),
                                   n_layers=cs.MIXTRAL_LAYERS)
        cs.deploy_int8(transformer.build(mcfg), wd, "mixtral-int8")
        torch.cuda.empty_cache()
        print(f"stores deployed in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for i, root in enumerate(roots):
            print(f"[run {i + 1} of {len(roots)}] {root}", flush=True)
            r = subprocess.run([sys.executable, "-c", RUN, wd], cwd=root)
            if r.returncode:
                print(f"chip_smoke_ab: run {i + 1} failed ({r.returncode})",
                      file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
