"""Work and bounds from a configuration's layer shapes, and the peaks.

A layer (``reference/<model>.layers``) does ``macs`` multiply-adds per
image: its conv over its output pixels plus the fused 1x1. Its bound at
batch n is the larger of its operations (2 x MACs) over the int8 peak and
its bytes over the memory bandwidth: inputs and weights (with the int32
bias and f32 scale of each output channel) read once, the output written
once, pooled where the layer carries its pool. That is the rule of the
port's kernel table (PERF.md), as a function of shapes: it never depends
on which kernel ran a layer. These are the published layer shapes, not what
a kernel executes (a strided stem's s2d taps, a pair kernel's redundant
rows).
"""
from __future__ import annotations

# Dense int8 tensor-core rate and HBM bandwidth by the device name that
# torch.cuda.get_device_name() gives (NVIDIA's H100 data sheet, SXM part,
# 700 W, no sparsity).
PEAKS = {"NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12,
                                   "bytes_per_s": 3.35e12}}


def out_hw(layer: dict) -> int:
    return layer["hw"] // layer["pool"]


def macs(layer: dict) -> int:
    """Multiply-adds per image."""
    k, ic, oc, oc1 = layer["k"], layer["ic"], layer["oc"], layer["oc1x1"]
    pixels = layer["hw"] ** 2
    return pixels * (k * k * ic * oc + (oc1 or 0) * oc)


def layer_bytes(layer: dict, n: int) -> int:
    """Bytes a layer must move at batch n: input, weights, output."""
    k, ic, oc, oc1 = layer["k"], layer["ic"], layer["oc"], layer["oc1x1"]
    inp = n * layer["hw"] ** 2 * ic
    wei = oc * ic * k * k + (oc1 or 0) * oc + 8 * (oc + (oc1 or 0))
    out_c = oc1 or oc
    out = n * out_hw(layer) ** 2 * out_c * (4 if layer["dst"] == "f32" else 1)
    return inp + wei + out


def bound_s(layer: dict, n: int, peak: dict):
    """(least seconds at batch n, "operations" or "bytes")."""
    ops_s = 2 * macs(layer) * n / peak["int8_ops_per_s"]
    bytes_s = layer_bytes(layer, n) / peak["bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def model_macs(layers: list) -> int:
    return sum(macs(l) for l in layers)


def model_bound_s(layers: list, n: int, peak: dict) -> float:
    """The sum of the layers' bounds at batch n."""
    return sum(bound_s(l, n, peak)[0] for l in layers)
