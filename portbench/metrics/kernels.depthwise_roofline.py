"""kernels.depthwise_roofline: the depthwise conv kernel's share of its
bound on a model path, in %: the sum over the model's depthwise layers of
each one's bound at the batch, over the device time of the traced
stretch's ``depthwise_kernel`` operations per call made in it. None where
no such operation is among the trace's device operations (a model without
depthwise layers, or a program that runs them another way).

A depthwise layer is marked in ``reference/<model>.layers`` by its
``depthwise`` key (``ic`` 1, ``oc`` its channels, ``hw`` its output
resolution). It reads its input once at the input's own resolution (``hw``
times its ``stride``), writes its output once and reads nine s8 weights, a
4-byte bias and a 4-byte scale a channel, so its bound is those bytes over
the memory bandwidth (``portbench/counts.py``'s peaks); its nine
multiply-adds an output byte run far below the int8 peak. (``counts.py``'s
rule reads a depthwise layer's input as one channel at the output's
resolution.)"""
import re

DEPTHWISE = "depthwise_kernel"


def layer_bytes(layer: dict, n: int) -> int:
    """Bytes a depthwise layer must move at batch n."""
    hw, c = layer["hw"], layer["oc"]
    in_hw = hw * layer.get("stride", 1)
    return n * (in_hw ** 2 + hw ** 2) * c + 17 * c


def bound_s(layer: dict, n: int, peak: dict) -> float:
    """Least seconds of a depthwise layer at batch n."""
    return layer_bytes(layer, n) / peak["bytes_per_s"]


def read(run):
    t = run.trace
    if t is None or run.peak is None or not run.traced_units:
        return None
    dw_s = sum(s for name, s in t["device_ops"]
               if DEPTHWISE in re.sub(r"[^A-Za-z0-9]", "_", name))
    if dw_s <= 0:
        return None
    bound = sum(bound_s(l, run.batch, run.peak)
                for l in run.layers if l.get("depthwise"))
    return 100.0 * bound / (dw_s / run.traced_units)
