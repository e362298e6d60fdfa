"""kernels.fused_block_roofline: the fused conv3x3+conv1x1 kernel's share of
its layers' bound, in %: the sum over the layers with a fused 1x1 of each
layer's bound at the batch, over the device time of the traced stretch's
``conv_fused_kernel<true, ...>`` operations per call made in it. None where
no such operation is among the trace's device operations (a model without
fused layers, or a program that runs them on another kernel).

A layer's bound is ``portbench/counts.py``'s rule (the larger of 2 x its
MACs over the int8 peak and its bytes over the memory bandwidth) with the
bytes that rule leaves out for these layers: the input at its own
resolution (``hw`` times the layer's ``stride``; ``counts`` reads it at the
output's) and the shortcut operand that the epilogue adds (a byte an
output element where the layer has a ``sum_dt``)."""
import re

from portbench import counts

FUSED = "conv_fused_kernel_true"


def bound_s(layer: dict, n: int, peak: dict) -> float:
    """Least seconds of a fused layer at batch n, its input and sum
    operand counted."""
    hw, ic = layer["hw"], layer["ic"]
    in_hw = hw * layer.get("stride", 1)
    nbytes = (counts.layer_bytes(layer, n) + n * ic * (in_hw ** 2 - hw ** 2)
              + (n * hw ** 2 * layer["oc1x1"] if layer.get("sum_dt") else 0))
    return max(2 * counts.macs(layer) * n / peak["int8_ops_per_s"],
               nbytes / peak["bytes_per_s"])


def read(run):
    t = run.trace
    if t is None or run.peak is None or not run.traced_units:
        return None
    fused_s = sum(s for name, s in t["device_ops"]
                  if FUSED in re.sub(r"[^A-Za-z0-9]", "_", name))
    if fused_s <= 0:
        return None
    bound = sum(bound_s(l, run.batch, run.peak)
                for l in run.layers if l["oc1x1"])
    return 100.0 * bound / (fused_s / run.traced_units)
