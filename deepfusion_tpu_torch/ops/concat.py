"""Concat(+ReLU) over NHWC channels.

The PyTorch counterpart of ``deepfusion_tpu/ops/concat.py``. On CUDA tensors
``concat`` launches ``concat_relu_kernel`` (``csrc/concat.cu``) through the
registered op ``torch.ops.deepfusion_torch.concat_relu``
(``csrc/torch_ops.cpp``); on CPU tensors it runs ``concat_plain``. ReLU is
true ReLU per dtype (the reference's lane quirks Q1/Q2 are not reproduced,
``ops/ref.py:23-27`` of the JAX package). ``concat()`` keeps its config per
shapes, dtype and ReLU, so a model's repeated call rebuilds none.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import _build
from ..config import ConcatConfig
from ..types import dtype
from ..utils.device import as_tensor
from ..utils.logger import check
from .requant import relu_f32


def relu(x: torch.Tensor, dt: dtype) -> torch.Tensor:
    """True ReLU per dtype: identity on u8, ``jnp.maximum`` semantics on
    f32."""
    if dt == dtype.u8:
        return x
    if dt == dtype.f32:
        return relu_f32(x)
    return x.clamp_min(0)


def concat_plain(srcs: Sequence[torch.Tensor], cfg: ConcatConfig):
    """The plain PyTorch version of ``concat_relu_kernel``."""
    out = torch.cat(list(srcs), dim=-1)
    return relu(out, cfg.dt) if cfg.with_relu else out


def concat_cuda(srcs: Sequence[torch.Tensor], cfg: ConcatConfig):
    """Launch ``concat_relu_kernel`` on the current stream through the
    registered op, which checks the inputs (at least one, one dtype,
    device, N, H and W, rows of 16-byte multiples), makes them contiguous
    and aligned, allocates the output and launches the kernel once for up
    to 128 inputs (once per group of 128 beyond), all in C++. The op
    returns the launches it made, and each of them is counted."""
    out, launches = _build.op("concat_relu")(srcs, cfg.with_relu)
    for _ in range(launches):
        _build.count_launch("concat_relu")
    return out


@functools.lru_cache(maxsize=64)
def _config(shapes: tuple, dt: torch.dtype,
            with_relu: bool) -> ConcatConfig:
    """``ConcatConfig.make``, once per shapes, dtype and ReLU; a call that
    fails raises again next time (``lru_cache`` keeps no exception)."""
    return ConcatConfig.make(list(shapes), dt, with_relu)


def concat(srcs: Sequence, post_relu: bool = False, *,
           device=None) -> torch.Tensor:
    """Concatenate NHWC tensors along channels, optionally fused with ReLU.

    Functional analogue of ``deepfusion::concat`` + ``op->submit()``
    (``include/deepfusion.h:116-118``). All inputs share dtype, device and
    batch/spatial dims; channel counts satisfy the reference's
    block-divisibility rule (``ConcatConfig.make``). Numpy inputs go to
    ``device``: by default the current CUDA device, ``"cpu"`` for the plain
    PyTorch version.
    """
    ts = [as_tensor(s, device) for s in srcs]
    cfg = _config(tuple(tuple(t.shape) for t in ts), ts[0].dtype,
                  bool(post_relu))
    for t in ts:
        if t.dtype != ts[0].dtype:
            raise ValueError("concat inputs must share dtype "
                             "(src/jit_concat_kernel.cc:183-185)")
        check(t.device == ts[0].device, "concat inputs must share a device")
    if ts[0].device.type == "cpu":
        return concat_plain(ts, cfg)
    return concat_cuda(ts, cfg)
