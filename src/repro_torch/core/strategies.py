"""The five loading strategies the paper evaluates (Sec. IV-A).

  traditional — Fig. 1: all layers constructed, then monolithic weight
                loading, then inference.  No pipelining.
  pisel       — the CIKM'24 baseline: 3-unit layer-wise pipeline
                (L_i -> W_i+A_i fused -> E_i), full numerical init,
                retrieval starts only after L_i completes.
  mini        — PISeL + MiniLoader (abstract construction, 1-bit
                placeholders).
  preload     — PISeL + WeightDecoupler (async retrieval issued at
                request arrival, out-of-order application) + the
                Priority-Aware Scheduler.
  cicada      — mini + preload (+ scheduler): the full system.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    mini: bool            # MiniLoader construction
    decouple: bool        # WeightDecoupler: async retrieval + OOO apply
    pipelined: bool       # layer-wise 3-unit pipeline (False: Fig. 1)
    scheduler: bool       # Priority-Aware Scheduler (Algorithm 1)


STRATEGIES = {
    "traditional": Strategy("traditional", False, False, False, False),
    "pisel": Strategy("pisel", False, False, True, False),
    "mini": Strategy("mini", True, False, True, False),
    "preload": Strategy("preload", False, True, True, True),
    "cicada": Strategy("cicada", True, True, True, True),
}


def get_strategy(name: str) -> Strategy:
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; have {sorted(STRATEGIES)}")
    return STRATEGIES[name]
