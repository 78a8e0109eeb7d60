"""Straggler mitigation + elastic-scaling utilities (the port of
``repro.distributed.resilience``).

``HeartbeatMonitor`` is the control-plane piece a 1000-node job needs:
every host reports per-step durations; hosts whose EMA exceeds
``threshold x`` the fleet median are flagged.  The remediation hooks are
deliberately mechanism-not-policy:

  * ``suggest_evict`` — drop the straggler and let ``reshard`` rebalance
    (elastic down-scale; the deterministic (seed, step) data pipeline
    means survivors recompute the lost shard with zero coordination);
  * backup-task dispatch for the *input* pipeline is free here because
    batches are pure functions of (seed, step) — any host can
    regenerate any shard.

``reshard`` is the elastic-scaling primitive: move a tree of tensors to
new placements (the port's ``NamedSharding``s, whose logical mesh lives
on one physical device, or plain devices).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import tree as tree_util

PyTree = Any


@dataclasses.dataclass
class HostStats:
    host: str
    ema_s: float = 0.0
    steps: int = 0
    last_seen: float = 0.0


class HeartbeatMonitor:
    def __init__(self, *, alpha: float = 0.3, threshold: float = 1.5,
                 timeout_s: float = 60.0):
        self.alpha = alpha
        self.threshold = threshold
        self.timeout_s = timeout_s
        self.hosts: Dict[str, HostStats] = {}

    def report(self, host: str, step_duration_s: float,
               now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        st = self.hosts.setdefault(host, HostStats(host))
        st.ema_s = (step_duration_s if st.steps == 0
                    else (1 - self.alpha) * st.ema_s
                    + self.alpha * step_duration_s)
        st.steps += 1
        st.last_seen = now

    def stragglers(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        live = [s for s in self.hosts.values()
                if now - s.last_seen <= self.timeout_s and s.steps > 0]
        out = [s.host for s in self.hosts.values()
               if s.steps > 0 and now - s.last_seen > self.timeout_s]
        if len(live) >= 2:
            med = statistics.median(s.ema_s for s in live)
            out += [s.host for s in live if s.ema_s > self.threshold * med]
        return sorted(set(out))

    def suggest_evict(self, now: Optional[float] = None) -> List[str]:
        """Hosts to drop at the next elastic re-shard."""
        return self.stragglers(now)


def _place(t: torch.Tensor, where) -> torch.Tensor:
    mesh = getattr(where, "mesh", None)
    return t.to(mesh.device if mesh is not None else torch.device(where))


def reshard(tree: PyTree, shardings: PyTree) -> PyTree:
    """Move a tree to new placements (elastic scale-up/down, mesh change):
    each leaf to its sharding's mesh device, or to its device."""
    return tree_util.tree_map(_place, tree, shardings)
