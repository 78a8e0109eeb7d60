"""Mean time from a request's submit to its first token, over every
request of the window (each a cold start), ms."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    v = stats.mean(r["t_first"] - r["t_submit"]
                   for r in window_requests(rec))
    return None if v is None else 1e3 * v
