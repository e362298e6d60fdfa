"""Concat(+ReLU) over NHWC channels.

The PyTorch counterpart of ``deepfusion_tpu/ops/concat.py``. On CUDA tensors
``concat`` launches ``concat_relu_kernel`` (``csrc/concat.cu``); on CPU
tensors it runs ``concat_plain``. ReLU is true ReLU per dtype (the
reference's lane quirks Q1/Q2 are not reproduced, ``ops/ref.py:23-27`` of the
JAX package).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build
from ..config import ConcatConfig
from ..types import dtype
from ..utils.device import as_tensor
from ..utils.logger import check
from .requant import relu_f32

MAX_INPUTS = 16  # csrc/concat.cu MAX_IN


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
    """Launch ``concat_relu_kernel`` on the current stream."""
    check(len(srcs) <= MAX_INPUTS,
          f"the concat kernel takes at most {MAX_INPUTS} inputs")
    srcs = [_build.aligned(s) for s in srcs]
    dev = srcs[0].device
    out = torch.empty((cfg.bs, cfg.h, cfg.w, cfg.oc), dtype=cfg.dt.torch,
                      device=dev)
    ptrs = (ctypes.c_void_p * len(srcs))(*[s.data_ptr() for s in srcs])
    widths = (ctypes.c_int * len(srcs))(*[ic * cfg.dt.size for ic in cfg.ics])
    with torch.cuda.device(dev):
        rc = _build.kernels().df_concat(
            ptrs, widths, len(srcs), out.data_ptr(),
            cfg.bs * cfg.h * cfg.w, int(cfg.with_relu), cfg.dt.value,
            _build.stream_of(out))
    _build.check(rc, "concat_relu_kernel")
    _build.count_launch("concat_relu")
    return out


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
    cfg = ConcatConfig.make([tuple(t.shape) for t in ts], ts[0].dtype,
                            post_relu)
    for t in ts:
        if t.dtype != ts[0].dtype:
            raise ValueError("concat inputs must share dtype "
                             "(src/jit_concat_kernel.cc:183-185)")
        check(t.device == ts[0].device, "concat inputs must share a device")
    if ts[0].device.type == "cpu":
        return concat_plain(ts, cfg)
    return concat_cuda(ts, cfg)
