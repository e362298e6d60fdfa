"""kernels.forward_roofline: the sum over the model's layers of each
layer's bound at the batch (portbench/counts.py), over the device time of
every kernel of one forward (the traced stretch's kernel time over the
calls made in it), in %."""
from portbench import counts


def read(run):
    t = run.trace
    if t is None or run.peak is None or not run.traced_units \
            or t["kernel_s"] <= 0:
        return None
    per_call = t["kernel_s"] / run.traced_units
    return 100.0 * counts.model_bound_s(run.layers, run.batch,
                                        run.peak) / per_call
