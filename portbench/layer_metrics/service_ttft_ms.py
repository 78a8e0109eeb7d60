"""Model step, prefill: mean ``Response.ttft_s`` (service start to first
token) of the window's requests, ms."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    v = stats.mean(r["ttft_s"] for r in window_requests(rec))
    return None if v is None else 1e3 * v
