"""L, A and in-pipeline E: mean ``Response.utilization`` of the window's
cold starts (the paper's pipeline utilization: merged L/A/E busy time
over the load, on the host's clock; not a device utilization), %."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    v = stats.mean(r["utilization"] for r in window_requests(rec)
                   if r["cold"])
    return None if v is None else 100.0 * v
