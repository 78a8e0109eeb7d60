"""Merge the static lock-order graph with the runtime probe's observed
graph and render JSON / human reports (a port of
``repro.analysis.lockgraph``).

The static side (``lint.build_static_lockgraph``) sees lexically nested
``with self.<lock>`` acquisitions plus one level of typed-attribute call
resolution; the runtime side (``locks.Probe``) sees every real
acquisition order the instrumented test run exercised, including
dynamic dispatch the AST cannot follow (callbacks, executor tasks,
closures handed across modules).  Merging both gives the strongest
cycle check either side can support: a cycle in the merged graph is a
deadlock hazard even if no single run interleaved into it.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import lint


def load_observed(path: str) -> Dict:
    """A ``repro-analysis-observed`` artifact dumped by the probe
    (``REPRO_ANALYZE_OUT`` or ``Probe.dump``)."""
    with open(path) as f:
        data = json.load(f)
    if data.get("kind") != "repro-analysis-observed":
        raise ValueError(f"{path}: not a repro-analysis-observed artifact")
    return data


def merge(static_edges: Sequence[lint.LockEdge],
          observed: Optional[Dict] = None) -> Dict:
    """Build the merged lockgraph report dict."""
    edges: Dict[Tuple[str, str], Dict] = {}
    for e in static_edges:
        rec = edges.setdefault((e.src, e.dst), {
            "src": e.src, "dst": e.dst, "static": [], "observed": 0})
        if e.where not in rec["static"]:
            rec["static"].append(e.where)
    obs_edges = (observed or {}).get("edges", [])
    for rec in obs_edges:
        src, dst, n = rec["src"], rec["dst"], rec.get("count", 1)
        merged = edges.setdefault((src, dst), {
            "src": src, "dst": dst, "static": [], "observed": 0})
        merged["observed"] += n
    cycles = lint.find_cycles(set(edges))
    report = {
        "kind": "repro-analysis-lockgraph",
        "edges": sorted(edges.values(),
                        key=lambda r: (r["src"], r["dst"])),
        "cycles": cycles,
        "locks": (observed or {}).get("locks", {}),
        "cv_waits": (observed or {}).get("cv_waits", {}),
        "hazards": (observed or {}).get("hazards", []),
        "observed_cycles": (observed or {}).get("cycles", []),
    }
    return report


def render(report: Dict) -> str:
    """Human-readable text for the ``report`` subcommand."""
    out: List[str] = []
    edges = report["edges"]
    out.append(f"lock-order graph: {len(edges)} edge(s)")
    for rec in edges:
        tags = []
        if rec["static"]:
            tags.append("static:" + ",".join(rec["static"][:2]))
        if rec["observed"]:
            tags.append(f"observed x{rec['observed']}")
        out.append(f"  {rec['src']} -> {rec['dst']}   [{'; '.join(tags)}]")
    if report["cycles"]:
        out.append(f"CYCLES ({len(report['cycles'])}) — deadlock hazards:")
        for cyc in report["cycles"]:
            out.append("  " + " -> ".join(cyc + [cyc[0]]))
    else:
        out.append("no cycles.")
    if report.get("hazards"):
        out.append(f"I/O-under-lock hazards ({len(report['hazards'])}):")
        for hz in report["hazards"]:
            out.append(f"  {hz['io']} with held "
                       f"{hz['held']} ({hz['thread']})")
    locks = report.get("locks") or {}
    if locks:
        out.append("lock hotspots (by total hold time):")
        ranked = sorted(locks.items(),
                        key=lambda kv: kv[1].get("hold_s", 0.0),
                        reverse=True)
        for name, st in ranked:
            out.append(
                f"  {name}: acquires={st.get('acquires', 0)} "
                f"contended={st.get('contended', 0)} "
                f"hold={st.get('hold_s', 0.0) * 1e3:.1f}ms "
                f"(max {st.get('hold_max_s', 0.0) * 1e3:.2f}ms) "
                f"wait={st.get('wait_s', 0.0) * 1e3:.1f}ms "
                f"(max {st.get('wait_max_s', 0.0) * 1e3:.2f}ms)")
    cvs = report.get("cv_waits") or {}
    if cvs:
        out.append("condition waits:")
        for name, st in sorted(cvs.items()):
            out.append(
                f"  {name}: waits={st.get('waits', 0)} "
                f"timed={st.get('timed_waits', 0)} "
                f"waited={st.get('wait_s', 0.0) * 1e3:.1f}ms")
    return "\n".join(out)
