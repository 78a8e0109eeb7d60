"""CLI: ``python -m repro_torch.analysis {lint,lockgraph,report}``.

* ``lint [paths...]`` — run R1–R4 over the given roots (default
  ``src/repro_torch``); exit 1 on findings not covered by the baseline
  (default: the port's own ``src/repro_torch/analysis/baseline.txt``) or
  an inline ``# analysis: ignore``.  Stale baseline entries are warnings.
* ``lockgraph [paths...] [--observed probe.json] [--json-out f]`` —
  build the static lock-order graph, merge an observed-probe artifact
  if given, exit 1 on cycles.
* ``report [--observed probe.json]`` — the human-readable merged
  report (edges, cycles, hazards, hold/wait hotspots).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis import lint, lockgraph


HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE = os.path.join(HERE, "baseline.txt")


def _default_roots():
    """``src/repro_torch`` of the checkout this module sits in."""
    return [os.path.normpath(os.path.join(HERE, ".."))]


def _default_baseline():
    return BASELINE if os.path.exists(BASELINE) else None


def cmd_lint(args) -> int:
    findings = lint.lint_paths(args.paths or _default_roots())
    baseline = lint.load_baseline(args.baseline) if args.baseline else {}
    unsuppressed, stale = lint.apply_baseline(findings, baseline)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                "kind": "repro-analysis-lint",
                "findings": [vars(x) | {"id": x.id} for x in findings],
                "unsuppressed": [x.id for x in unsuppressed],
                "stale_baseline": stale,
            }, f, indent=2)
    for f in unsuppressed:
        print(f.render())
    for fid in stale:
        print(f"warning: stale baseline entry (no such finding): {fid}",
              file=sys.stderr)
    n_base = len(findings) - len(unsuppressed)
    print(f"{len(findings)} finding(s), {n_base} baselined, "
          f"{len(unsuppressed)} blocking.")
    return 1 if unsuppressed else 0


def cmd_lockgraph(args) -> int:
    models = []
    for root in (args.paths or _default_roots()):
        models.extend(lint.load_models(root))
    edges, _ = lint.build_static_lockgraph(models)
    observed = lockgraph.load_observed(args.observed) \
        if args.observed else None
    report = lockgraph.merge(edges, observed)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
    print(lockgraph.render(report))
    if report["cycles"]:
        print(f"FAIL: {len(report['cycles'])} lock-order cycle(s).",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="run rules R1-R4")
    lp.add_argument("paths", nargs="*")
    lp.add_argument("--baseline", default=_default_baseline())
    lp.add_argument("--json-out")
    lp.set_defaults(fn=cmd_lint)

    gp = sub.add_parser("lockgraph",
                        help="static+observed lock-order graph")
    gp.add_argument("paths", nargs="*")
    gp.add_argument("--observed")
    gp.add_argument("--json-out")
    gp.set_defaults(fn=cmd_lockgraph)

    rp = sub.add_parser("report", help="human-readable merged report")
    rp.add_argument("paths", nargs="*")
    rp.add_argument("--observed")
    rp.add_argument("--json-out")
    rp.set_defaults(fn=cmd_lockgraph)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
