"""serve.flush_host_us: the mean, over the flushes within the traced
stretch, of the worker's own work per flush: ``serve.flush`` less its
``serve.wait`` and ``serve.gather`` (stack, H2D, forward, D2H, resolve),
in us."""
from portbench import spans


def read(run):
    v = spans.mean(spans.flush_host_ns(run))
    return None if v is None else v / 1e3
