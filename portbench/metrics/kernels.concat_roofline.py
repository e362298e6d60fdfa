"""kernels.concat_roofline: the channel concat kernel's share of its bound
on a model path, in %: the sum over the model's concats of each one's
bound at the batch, over the device time of the traced stretch's
``concat_relu_kernel`` operations per call made in it. None where no such
operation is among the trace's device operations (a model without
concats, or a program that joins its branches another way).

A concat is marked in ``reference/<model>.layers`` by the ``concat`` key
of the layer that ends its module: the lanes it writes at that layer's
``hw``. It reads every input byte once and writes each output byte once,
so its bound is 2 x n x hw**2 x lanes bytes over the memory bandwidth
(``portbench/counts.py``'s peaks); it does no arithmetic."""
import re

CONCAT = "concat_relu_kernel"


def bound_s(layer: dict, n: int, peak: dict) -> float:
    """Least seconds of the concat that `layer` marks, at batch n."""
    return 2 * n * layer["hw"] ** 2 * layer["concat"] / peak["bytes_per_s"]


def read(run):
    t = run.trace
    if t is None or run.peak is None or not run.traced_units:
        return None
    concat_s = sum(s for name, s in t["device_ops"]
                   if CONCAT in re.sub(r"[^A-Za-z0-9]", "_", name))
    if concat_s <= 0:
        return None
    bound = sum(bound_s(l, run.batch, run.peak)
                for l in run.layers if l.get("concat"))
    return 100.0 * bound / (concat_s / run.traced_units)
