"""Store and retrieval: mean ``Response.load_s`` of the window's cold
starts over the I/O floor (the store's bytes at the simulated device's
bandwidth)."""
from portbench import stats
from portbench.records import window_requests


def read(rec):
    store = rec.get("store")
    if not store or store["mbps"] <= 0:
        return None
    floor = store["bytes"] / (store["mbps"] * 1e6)
    v = stats.mean(r["load_s"] for r in window_requests(rec) if r["cold"])
    return None if v is None else v / floor
