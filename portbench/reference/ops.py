"""Plain int8 inference ops in PyTorch: the yardstick's own arithmetic.

The numerical contract of the JAX package's oracle (``ops/ref.py``),
written again here so that the benchmark holds the port against code that
shares nothing with it:

1. a convolution accumulates u8 x s8 exactly (an s32 accumulator);
2. requantization is ``f32(acc) + f32(bias)``, then ``* f32(scale)``;
3. ReLU before rounding, forced for a u8 destination and for the fused
   3x3 intermediate;
4. rounding half to even; an f32 destination is not rounded;
5. saturation to [0, 255] for u8;
6. the average pool (excluding padding) sums exactly, multiplies by the
   f32 reciprocal of the tap count (how XLA compiles the JAX package's
   constant division), rounds and saturates.

Activations travel as float32 tensors that hold integers. A convolution is
a sum of one matrix product per tap in float32 with TF32 off: every product
and every partial sum is an integer below 2**24, so float32 holds each one
exactly and the order of the sums does not matter. ``conv_acc`` refuses
weights for which that bound does not hold.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EXACT = 2 ** 24   # float32 holds every integer below this


def strict_fp32() -> None:
    """Float32 products in full float32: TF32 would round their inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def conv_acc(x: torch.Tensor, wei: np.ndarray, stride: int = 1
             ) -> torch.Tensor:
    """The exact accumulator of a same-padded convolution.

    x: (n, h, w, ic) float32 holding u8 values; wei: (oc, ic, k, k) int8.
    Returns (n, oh, ow, oc) float32 holding the s32 sums."""
    oc, ic, k, _ = wei.shape
    bound = int(np.abs(wei.astype(np.int64)).max()) * 255 * k * k * ic
    if bound >= EXACT:
        raise ValueError(f"conv_acc: sums up to {bound} are not exact in "
                         "float32")
    pad = k // 2
    n, h, w, _ = x.shape
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    wt = torch.as_tensor(wei, device=x.device).to(torch.float32)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    acc = None
    for ki in range(k):
        for kj in range(k):
            patch = xp[:, ki:ki + (oh - 1) * stride + 1:stride,
                       kj:kj + (ow - 1) * stride + 1:stride, :]
            term = patch @ wt[:, :, ki, kj].T
            acc = term if acc is None else acc + term
    return acc


def requant(acc: torch.Tensor, bias: np.ndarray, scale: np.ndarray,
            relu: bool, dst: str) -> torch.Tensor:
    """``f32(acc) + f32(bias)``, ``* f32(scale)``, ReLU (forced for u8),
    then for u8 round half to even and saturate; float32 out."""
    dev = acc.device
    x = acc + torch.as_tensor(np.asarray(bias, np.float32), device=dev)
    x = x * torch.as_tensor(np.asarray(scale, np.float32), device=dev)
    if relu or dst == "u8":
        x = torch.clamp_min(x, 0.0)
    if dst == "u8":
        x = torch.round(x).clamp(0.0, 255.0)
    return x


def conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """One layer as the models define it: a conv with its requant, and
    where the layer has ``wei1`` the fused 1x1 after a u8 intermediate."""
    acc = conv_acc(x, p["wei"], stride)
    if p.get("wei1") is None:
        return requant(acc, p["bia"], p["conv0_scales"],
                       bool(p["conv0_relu"]), p["dst_dt"])
    mid = requant(acc, p["bia"], p["conv0_scales"], True, "u8")
    acc1 = conv_acc(mid, p["wei1"])
    return requant(acc1, p["bia1"], p["conv1_scales"],
                   bool(p["conv1_relu"]), p["dst_dt"])


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def sum_relu_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating u8 sum with ReLU."""
    return (a + b).clamp(0.0, 255.0)


def global_avgpool_u8(x: torch.Tensor) -> torch.Tensor:
    """Average over all pixels: the exact sum times the f32 reciprocal of
    the pixel count, rounded half to even, saturated; (n, 1, 1, c)."""
    n, h, w, c = x.shape
    inv = float(np.float32(1.0 / (h * w)))
    s = x.sum(dim=(1, 2), keepdim=True)
    return torch.round(s * inv).clamp(0.0, 255.0)


def head(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The f32 classifier over the pooled features: (n, classes)."""
    y = conv(x, p)
    return y.reshape(y.shape[0], -1)
