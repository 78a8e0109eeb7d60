"""Cicada core of the port — the paper's contribution.

  pipeline     stage tracer, Gantt recorder, utilization math
  miniloader   meta-device construction + 1-bit placeholders (Sec. III-B)
  decoupler    async retrieval + out-of-order application (Sec. III-C/D)
  scheduler    Priority-Aware Scheduler, Algorithm 1 (Sec. III-E)
  strategies   traditional | pisel | mini | preload | cicada
  units        PipelineUnit runtime: event-driven execution units
  coldstart    ColdStartEngine: request -> live model via the pipeline
"""
from repro_torch.core.coldstart import ColdStartEngine, LoadResult  # noqa: F401
from repro_torch.core.pipeline import PipelineTrace, StageEvent  # noqa: F401
from repro_torch.core.scheduler import PriorityAwareScheduler  # noqa: F401
from repro_torch.core.strategies import STRATEGIES, Strategy, get_strategy  # noqa: F401
from repro_torch.core.units import (PipelineContext, PipelineRuntime,  # noqa: F401
                                    PipelineState, PipelineUnit)
