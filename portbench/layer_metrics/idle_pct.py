"""Device: the share of the traced window in which no operation ran on
the card (``torch.profiler``), %."""
from portbench.records import traced


def read(rec):
    t = traced(rec)
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
