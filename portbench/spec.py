"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, each
with its configuration (``configs/<config>.json``) and traffic mix
(``mixes/<traffic>.json``, read by ``traffic/<generator>.py``), and the
metrics; each cell's own file (``workloads/<cell>.json``) holds the
driver that runs it (``drivers/<driver>.py``), its load, the entry's
settings and the limits of its check.  A metric ``name.suffix``
is read by ``layer_metrics/name.py`` or ``end_to_end/name.py``.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict[str, Any]:
    return _load(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    """The cell's entry in ``BENCHMARK.json`` (configuration, traffic,
    chips, why) with its own file's settings (driver, load, entry,
    check)."""
    entry = next(w for w in manifest()["workloads"] if w["name"] == name)
    return {**entry, **_load(HERE / "workloads" / f"{name}.json")}


def config(name: str) -> Dict[str, Any]:
    return _load(HERE / "configs" / f"{name}.json")


def mix(name: str) -> Dict[str, Any]:
    return _load(HERE / "mixes" / f"{name}.json")


def peaks() -> Dict[str, Any]:
    return _load(HERE / "peaks.json")


def module(kind: str, name: str):
    """``portbench.<kind>.<name>``: a generator, a driver or a reader."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def reader(metric: str, per_layer: bool):
    """The reader of ``metric``: the part of its name before the first
    dot names the file, so ``idle_pct.cold`` and ``idle_pct.chat`` share
    ``layer_metrics/idle_pct.py``."""
    base = metric.split(".", 1)[0]
    return module("layer_metrics" if per_layer else "end_to_end", base)


def metrics_for(cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` prints: its end-to-end ones with
    ``--trace 0``, its per-layer ones with ``--trace 1``."""
    m = manifest()
    entries = m["per_layer"] if trace else m["end_to_end"]
    return [e for e in entries
            if "workloads" not in e or cell in e["workloads"]]
