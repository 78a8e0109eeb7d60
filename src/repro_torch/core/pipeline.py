"""Pipeline instrumentation: stage events, Gantt rows, utilization math.

The paper's metrics (Sec. IV-C) all derive from per-stage timestamps:

  * working time  — duration of each stage event;
  * waiting time  — start(current stage) - end(predecessor stage), per
    layer (Q3 / Fig. 11);
  * pipeline utilization — union of busy intervals (overlaps merged)
    divided by total pipeline time (Q4 / Fig. 12-13);
  * Gantt timeline — events grouped by execution-unit row
    (Layer / Retrieve / Weight / Compute, Fig. 14).

Stages: L = layer construction, R = weight file retrieval (its own row
only under the WeightDecoupler), A = weight application, E = inference
execution, T = per-shard weight transform (dequant/cast on the shard
committer's placement lane under a mesh, before A).  Thread-safe;
timestamps are ``time.monotonic()``.

T events carry ``meta={"shard": <device index>}`` and live on their own
Gantt row; they are *excluded* from the default busy/utilization stage
set, as R is: transform work rides the retrieval lanes, so counting it
would double-book intervals the utilization metric treats as
overlap-eligible I/O time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch import analysis

STAGE_ROW = {"L": "Layer", "R": "Retrieve", "T": "Transform",
             "A": "Weight", "E": "Compute"}
PRED = {"A": "L", "E": "A"}       # waiting-time predecessor (paper Sec IV-C)


@dataclasses.dataclass
class StageEvent:
    stage: str                    # "L" | "R" | "T" | "A" | "E"
    layer: str                    # unit name, e.g. "block_003"
    t_start: float
    t_end: float
    meta: Optional[dict] = None   # R events: {"cached": True} served by
                                  # the WeightCache, {"shard": i} a shard
                                  # stream; T events: {"shard": i}

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def row(self) -> str:
        return STAGE_ROW[self.stage]


class PipelineTrace:
    def __init__(self):
        self._lock = analysis.make_lock("PipelineTrace._lock")
        # append-only while pipeline threads run; queries read after
        # the join, so only writes need the lock
        self.events: List[StageEvent] = []    # guarded-by[writes]: _lock
        self.t0: Optional[float] = None
        self.t_end: Optional[float] = None
        # (layer, placeholder_bytes, t_construct_end, t_apply_end)
        self.memory: List[Tuple[str, int, float, float]] = []  # guarded-by[writes]: _lock

    # ------------------------------------------------------------- recording
    def start(self):
        self.t0 = time.monotonic()

    def finish(self):
        self.t_end = time.monotonic()

    def record(self, stage: str, layer: str):
        """Context manager timing one stage event."""
        trace = self

        class _Ctx:
            def __enter__(self):
                self.ts = time.monotonic()
                return self

            def __exit__(self, *exc):
                te = time.monotonic()
                with trace._lock:
                    trace.events.append(StageEvent(stage, layer, self.ts, te))
                return False

        return _Ctx()

    def add_event(self, stage: str, layer: str, t_start: float, t_end: float,
                  meta: Optional[dict] = None):
        with self._lock:
            self.events.append(StageEvent(stage, layer, t_start, t_end, meta))

    def record_memory(self, layer: str, nbytes: int, t_construct_end: float,
                      t_apply_end: float):
        with self._lock:
            self.memory.append((layer, nbytes, t_construct_end, t_apply_end))

    # --------------------------------------------------------------- queries
    def _bounds(self) -> Tuple[float, float]:
        ts = self.t0 if self.t0 is not None else \
            min(e.t_start for e in self.events)
        te = self.t_end if self.t_end is not None else \
            max(e.t_end for e in self.events)
        return ts, te

    def total_time(self) -> float:
        ts, te = self._bounds()
        return te - ts

    @staticmethod
    def merge_intervals(iv: Iterable[Tuple[float, float]]
                        ) -> List[Tuple[float, float]]:
        ivs = sorted(iv)
        out: List[Tuple[float, float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_time(self, stages: Optional[Iterable[str]] = ("L", "A", "E")
                  ) -> float:
        """Union of busy intervals.  The default stage set counts only
        *execution-unit work* — retrieval (R) is kernel/DMA time during
        which the issuing unit idles (the paper's Fig. 5c framing), so
        it is excluded: under PISeL that I/O sits on the critical path
        and shows up as idle, under the WeightDecoupler it overlaps
        construction and utilization approaches 100%."""
        evs = [e for e in self.events
               if stages is None or e.stage in stages]
        merged = self.merge_intervals((e.t_start, e.t_end) for e in evs)
        return sum(e - s for s, e in merged)

    def utilization(self) -> float:
        """Merged busy time / total pipeline time (paper Q4)."""
        t = self.total_time()
        return self.busy_time() / t if t > 0 else 0.0

    def work_by_stage(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e.stage] = out.get(e.stage, 0.0) + e.duration
        return out

    def events_for(self, stage: str) -> Dict[str, StageEvent]:
        return {e.layer: e for e in self.events if e.stage == stage}

    def wait_by_stage(self) -> Dict[str, float]:
        """Per-layer waiting time: start(stage_i) - end(pred_i), summed.

        A's predecessor is L (the paper's "weight wait"); E's is A
        ("compute wait").  Negative gaps (stage started before its
        logical predecessor ended — impossible by construction) clamp
        to 0.
        """
        out: Dict[str, float] = {}
        for stage, pred in PRED.items():
            cur = self.events_for(stage)
            prev = self.events_for(pred)
            w = 0.0
            for layer, e in cur.items():
                if layer in prev:
                    w += max(0.0, e.t_start - prev[layer].t_end)
            out[stage] = w
        return out

    # ------------------------------------------------------- memory metrics
    def memory_overhead_bytes(self) -> int:
        """Peak construction-placeholder residency (paper Fig. 10 left)."""
        points = []
        for _, nbytes, t0, t1 in self.memory:
            points.append((t0, nbytes))
            points.append((t1, -nbytes))
        points.sort()
        cur = peak = 0
        for _, d in points:
            cur += d
            peak = max(peak, cur)
        return peak

    def memory_total_bytes(self) -> int:
        """Placeholder bytes summed over every layer, resident at once or
        not (paper Fig. 10)."""
        return sum(n for _, n, _, _ in self.memory)

    def memory_usage_time(self) -> float:
        """Cumulative placeholder-residency duration over all layers
        (paper Fig. 10 right)."""
        return sum(t1 - t0 for _, _, t0, t1 in self.memory)

    # ----------------------------------------------------------------- gantt
    def gantt_rows(self) -> List[dict]:
        """Every stage event in start order, times from the trace's first
        event (paper Fig. 14's timeline as data)."""
        ts, _ = self._bounds()
        return [{"row": e.row, "stage": e.stage, "layer": e.layer,
                 "start": e.t_start - ts, "end": e.t_end - ts}
                for e in sorted(self.events, key=lambda e: e.t_start)]

    def render_gantt(self, width: int = 100) -> str:
        """ASCII Gantt chart (Fig. 14 analogue)."""
        if not self.events:
            return "(empty trace)"
        ts, te = self._bounds()
        span = max(te - ts, 1e-9)
        lines = []
        for row in STAGE_ROW.values():
            evs = [e for e in self.events if e.row == row]
            if not evs:
                continue
            buf = [" "] * width
            for e in evs:
                a = int((e.t_start - ts) / span * (width - 1))
                b = max(a + 1, int((e.t_end - ts) / span * (width - 1)) + 1)
                ch = e.layer[-1] if e.layer else "#"
                for i in range(a, min(b, width)):
                    buf[i] = ch
            lines.append(f"{row:9s}|{''.join(buf)}|")
        lines.append(f"{'':9s} 0{'':{width - 8}s}{span * 1e3:.0f} ms")
        return "\n".join(lines)

    def summary(self) -> dict:
        work = self.work_by_stage()
        wait = self.wait_by_stage()
        return {
            "total_s": self.total_time(),
            "utilization": self.utilization(),
            "work_L": work.get("L", 0.0),
            "work_R": work.get("R", 0.0),
            "work_T": work.get("T", 0.0),
            "work_A": work.get("A", 0.0),
            "work_E": work.get("E", 0.0),
            "wait_A": wait.get("A", 0.0),
            "wait_E": wait.get("E", 0.0),
            "mem_overhead_bytes": self.memory_overhead_bytes(),
            "mem_usage_time_s": self.memory_usage_time(),
        }
