"""Generation: tokens the decode steps emitted in the window over the
steps the scheduler ran in it (the mean live rows of a step)."""
from portbench.records import decode_tokens


def read(rec):
    n = rec.get("steps")
    if not n:
        return None
    t0, t1 = rec["t0"], rec["t1"]
    return sum(1 for t, _ in decode_tokens(rec) if t0 <= t < t1) / n
