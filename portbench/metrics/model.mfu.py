"""model.mfu: the whole step's share of the int8 peak, in %: 2 x the
model's MACs per image (published layer shapes) x images/s of the window,
over the peak of the device (portbench/counts.py)."""
from portbench import counts


def read(run):
    if run.images is None or run.peak is None:
        return None
    ops = 2 * counts.model_macs(run.layers) * run.images / run.seconds
    return 100.0 * ops / run.peak["int8_ops_per_s"]
