"""Router and pool: mean ``Response.queue_s`` (admission to service
start) of the window's requests, ms."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    v = stats.mean(r["queue_s"] for r in window_requests(rec)
                   if r["queue_s"] is not None)
    return None if v is None else 1e3 * v
