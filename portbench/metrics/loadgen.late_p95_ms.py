"""loadgen.late_p95_ms: the 95th percentile of how late the open loop's
sender sent each request of the window (send time - due time): whether the
program's threads starve the client under the interpreter lock."""
from portbench.stats import percentile


def read(run):
    if run.late_s is None:
        return None
    return 1e3 * percentile(run.late_s, 95)
