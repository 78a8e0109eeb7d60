"""95th percentile of every inter-token gap, of every request, that
ends in the window, ms."""
from portbench import stats
from portbench.records import token_times


def read(rec):
    v = stats.quantile(stats.gaps_ending_in(token_times(rec), rec["t0"],
                                            rec["t1"]), 0.95)
    return None if v is None else 1e3 * v
