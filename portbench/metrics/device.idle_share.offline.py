"""device.idle_share.offline: the share of the traced stretch in which no
kernel, copy or fill ran on the device, in %."""
from portbench.stats import idle_share_pct


def read(run):
    return idle_share_pct(run)
