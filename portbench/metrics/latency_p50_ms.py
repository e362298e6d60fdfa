"""latency_p50_ms: the median, over every request due in the window, of
due time to result (a request never answered ranks last)."""
from portbench.stats import percentile


def read(run):
    if run.latencies_s is None:
        return None
    return 1e3 * percentile(run.latencies_s, 50)
