"""Generation: the window over the decode steps the scheduler ran in it
(``DecodeScheduler.stats()``), ms a step."""


def read(rec):
    n = rec.get("steps")
    if not n:
        return None
    return 1e3 * (rec["t1"] - rec["t0"]) / n
