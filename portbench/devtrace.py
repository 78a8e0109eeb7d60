"""The device's side of a traced run, from ``torch.profiler`` (CUPTI).

Records the CUDA activity only (kernels, copies, sets), over a window
the driver opens and closes, and reduces it to:

* ``busy_s``: the union of the intervals in which an operation ran on
  the device, ``window_s`` the host-clock length of the traced window;
* the device seconds of each kernel family inside the window, by the
  kernels' names
  (:data:`FAMILIES`: the port's kernels live in an anonymous namespace,
  so a name is matched after ``::`` or a space);
* ``breakdown``: the ten operations that took most device time, and the
  idle gaps summed by the benchmark's spans open across them.
"""
from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional

FAMILIES = {
    "weight_transform": r"(dequant_kernel|cast_kernel)",
    "flash_attention": r"(flash_tc_kernel|flash_kernel)",
    "quant_matmul": r"(qmm_tc_kernel|qmm_reduce_kernel|qmm_kernel)",
    "decode_attention": r"(split_kernel|merge_kernel)",
    "rmsnorm": r"(rmsnorm_kernel)",
}
SHORT_GAP_NS = 1_000_000     # gaps below this are summed, not labelled
_FAMILY_RE = {k: re.compile(r"(^|::|\s)" + v + r"\b")
              for k, v in FAMILIES.items()}
def family(name: str) -> Optional[str]:
    for fam, rx in _FAMILY_RE.items():
        if rx.search(name):
            return fam
    return None


def short(name: str) -> str:
    """A kernel's qualified name without its return type, anonymous
    namespace and template or call arguments; copies and sets whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:80]
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    m = re.match(r"[\w:]+", n)
    return (m.group(0) if m else name)[:80]


class DeviceTrace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None
        self.offset_ns = 0          # epoch ns - monotonic ns
        self.events: List[tuple] = []

    def start(self):
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.t0 = time.monotonic()

    def stop(self):
        if not self.enabled or self.prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()
        res = self.prof.profiler.kineto_results
        ev = []
        for e in res.events():
            if e.device_type().name != "CUDA":
                continue
            ev.append((e.name(), e.start_ns(), e.duration_ns()))
        self.events = ev
        self.prof = None

    def summary(self, spans=None) -> Dict[str, Any]:
        """busy_s, window_s, kernel seconds by family and the breakdown."""
        if self.t0 is None or self.t1 is None:
            return {}
        a_ns = int(self.t0 * 1e9) + self.offset_ns
        b_ns = int(self.t1 * 1e9) + self.offset_ns
        ivs = sorted((max(s, a_ns), min(s + d, b_ns))
                     for _, s, d in self.events if s + d > a_ns and s < b_ns)
        busy = 0
        gaps = []
        cur_a = cur_b = None
        last_end = a_ns
        for s, e in ivs:
            if cur_b is None or s > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if s > last_end:
                    gaps.append((last_end, s))
                cur_a, cur_b = s, e
            else:
                cur_b = max(cur_b, e)
            last_end = max(last_end, e)
        if cur_b is not None:
            busy += cur_b - cur_a
        if b_ns > last_end:
            gaps.append((last_end, b_ns))
        fam: Dict[str, float] = {}
        ops: Dict[str, float] = {}
        for name, s, d in self.events:
            inside = min(s + d, b_ns) - max(s, a_ns)   # the part in the window
            if inside <= 0:
                continue
            f = family(name)
            if f is not None:
                fam[f] = fam.get(f, 0.0) + inside / 1e9
            k = short(name)
            ops[k] = ops.get(k, 0.0) + inside / 1e9
        idle: Dict[str, float] = {}
        if spans is not None:
            for s, e in gaps:
                if e - s < SHORT_GAP_NS:
                    label = "gaps under 1 ms between operations"
                else:
                    mid = ((s + e) / 2 - self.offset_ns) / 1e9
                    label = "+".join(spans.open_at(mid)) or "no call open"
                idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa
        return {"busy_s": busy / 1e9, "window_s": self.t1 - self.t0,
                "t0": self.t0, "t1": self.t1, "family_s": fam,
                "breakdown": {"device_ops": [list(x) for x in top(ops)],
                              "idle_gaps": [list(x) for x in top(idle)]}}
