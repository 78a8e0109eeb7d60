"""95th percentile, over every request due in the window, of the time
from its due time to its first token, ms."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    v = stats.quantile([r["t_first"] - r["t_due"]
                        for r in window_requests(rec)], 0.95)
    return None if v is None else 1e3 * v
