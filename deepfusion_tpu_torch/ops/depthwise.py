"""INT8 3x3 depthwise conv (+ReLU) into u8: ``DepthwiseOp``.

A port-only op: the JAX package has no depthwise conv (its ``ConvConfig``
refuses ``groups`` other than 1), and MobileNetV2's inverted residual blocks
need one (``models/mobilenetv2.py``). Each channel is convolved with its
own 3x3 filter, padding 1, stride 1 or 2, over NHWC u8; the s32
accumulator is requantized exactly as the dense conv's u8 destination is
(``ops/requant.py``): ``f32(acc) + bias``, ``* scale``, ReLU, round half
to even, saturate to u8.

A ``DepthwiseOp`` holds its weights on its device as ``wcols``, the words
the kernel reads (``column_words``), with its per-channel bias and scale
as f32. On a CUDA tensor it launches ``depthwise_kernel``
(``csrc/depthwise.cu``) through ``torch.ops.deepfusion_torch.depthwise``;
on a CPU tensor it runs ``depthwise_plain``, the plain PyTorch version,
which reads the same words. Channels are a multiple of 16 (the kernel's
16-byte vectors).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from ..types import dtype, round_mode
from ..utils.device import default_device
from ..utils.logger import check, check_eq
from ..utils.mathutil import conv_output_size
from . import layout
from .requant import requant


@dataclasses.dataclass(frozen=True)
class DepthwiseConfig:
    """A 3x3 depthwise conv with padding 1 into u8 (ReLU forced, rounded
    to nearest): batch, image, channels, output, stride and per-channel
    scales."""

    bs: int
    ih: int
    iw: int
    c: int
    oh: int
    ow: int
    stride: int
    scales: Tuple[float, ...]

    @staticmethod
    def make(src_shape, wei_shape, stride: int,
             scales) -> "DepthwiseConfig":
        """Validate and build; src NHWC, weights (c, 1, 3, 3), a scale a
        channel."""
        n, ih, iw, c = src_shape
        check_eq(tuple(wei_shape), (c, 1, 3, 3),
                 "depthwise weight shape (c, 1, 3, 3)")
        check(c % 16 == 0 and c > 0,
              f"depthwise channels must be a multiple of 16, got {c}")
        check(stride in (1, 2), f"depthwise stride must be 1 or 2, "
                                f"got {stride}")
        sc = np.asarray(scales, dtype=np.float32).reshape(-1)
        check_eq(sc.size, c, "depthwise scales, one a channel")
        return DepthwiseConfig(
            bs=n, ih=ih, iw=iw, c=c, oh=conv_output_size(ih, 3, stride, 1),
            ow=conv_output_size(iw, 3, stride, 1), stride=stride,
            scales=tuple(float(x) for x in sc))


def column_words(wei) -> np.ndarray:
    """The kernel's weights: (3, c) int32, word [kj][o] holding channel o's
    taps of column kj, rows 0, 1, 2 in bytes 0, 1, 2 (their s8 bits) and 0
    in byte 3, so that a dp4a against the column's three input rows of the
    channel adds exactly its three products."""
    w = np.asarray(wei, dtype=np.int8).reshape(-1, 3, 3).view(np.uint8)
    b = w.astype(np.uint32)                       # (c, ki, kj)
    words = b[:, 0, :] | b[:, 1, :] << 8 | b[:, 2, :] << 16
    return np.ascontiguousarray(words.T).view(np.int32)


def unpack_column_words(wcols: torch.Tensor) -> torch.Tensor:
    """``column_words`` inverted: (c, 3, 3) int8 weights, [o, ki, kj]."""
    bytes_ = wcols.contiguous().view(torch.uint8).reshape(3, -1, 4)
    return bytes_[..., :3].permute(1, 2, 0).contiguous().view(torch.int8)


def depthwise_geo(cfg: DepthwiseConfig) -> tuple:
    """The op's ints as ``torch.ops.deepfusion_torch.depthwise`` takes them
    (``csrc/torch_ops.cpp``, ``DepthwiseGeo``)."""
    return (cfg.ih, cfg.iw, cfg.oh, cfg.ow, cfg.c, cfg.stride)


class DepthwiseOp(nn.Module):
    """Pre-packed 3x3 depthwise conv into u8, on its device (by default the
    current CUDA device)."""

    def __init__(self, cfg: DepthwiseConfig, wei, bia, device=None):
        super().__init__()
        check_eq(tuple(np.shape(wei)), (cfg.c, 1, 3, 3),
                 "depthwise weight shape (c, 1, 3, 3)")
        check_eq(np.shape(bia), (cfg.c,), "depthwise bias shape (c,)")
        device = default_device(device)
        self.cfg = cfg
        self.register_buffer("wcols", torch.as_tensor(column_words(wei),
                                                      device=device))
        self.register_buffer("bias", torch.as_tensor(
            layout.widen_bias(bia, cfg.c), device=device))
        self.register_buffer("scale", torch.as_tensor(
            np.asarray(cfg.scales, dtype=np.float32), device=device))
        self._geo = depthwise_geo(cfg)

    @property
    def device(self) -> torch.device:
        return self.wcols.device

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        check_eq(src.dtype, torch.uint8, "depthwise src dtype")
        check_eq(tuple(src.shape[1:]), (cfg.ih, cfg.iw, cfg.c),
                 "depthwise src shape (NHWC, any batch)")
        check_eq(src.device, self.device, "depthwise src device")
        if src.device.type == "cpu":
            return depthwise_plain(self, src)
        return depthwise_cuda(self, src)


def depthwise_acc(src: torch.Tensor, wei: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """The exact s32 accumulator of a 3x3 depthwise conv with padding 1:
    src NHWC u8, wei (c, 3, 3) int8; the nine taps' products summed in
    float64 (every partial sum an integer far below 2^53)."""
    n, ih, iw, c = src.shape
    oh = conv_output_size(ih, 3, stride, 1)
    ow = conv_output_size(iw, 3, stride, 1)
    x = F.pad(src.to(torch.float64), (0, 0, 1, 1, 1, 1))
    w = wei.to(torch.float64)
    acc = torch.zeros((n, oh, ow, c), dtype=torch.float64, device=src.device)
    for ki in range(3):
        for kj in range(3):
            acc += x[:, ki:ki + (oh - 1) * stride + 1:stride,
                     kj:kj + (ow - 1) * stride + 1:stride, :] * w[:, ki, kj]
    return acc.to(torch.int32)


def depthwise_plain(op: DepthwiseOp, src: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``depthwise_kernel``, from the op's
    packed words."""
    cfg = op.cfg
    acc = depthwise_acc(src, unpack_column_words(op.wcols), cfg.stride)
    return requant(acc, op.bias, op.scale, True, round_mode.nearest,
                   dtype.u8)


def depthwise_cuda(op: DepthwiseOp, src: torch.Tensor) -> torch.Tensor:
    """Launch ``depthwise_kernel`` on the current stream through
    ``torch.ops.deepfusion_torch.depthwise``."""
    out = _build.op("depthwise")(src, op.wcols, op.bias, op.scale, op._geo)
    _build.count_launch("depthwise")
    return out

