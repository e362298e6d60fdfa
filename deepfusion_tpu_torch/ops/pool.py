"""Pooling and eltwise-sum+ReLU over NHWC tensors.

The PyTorch counterparts of ``deepfusion_tpu/ops/pool.py:pool`` and
``eltwise_sum_relu``. On CUDA tensors they launch ``pool_kernel``
(``csrc/pool.cu``) and ``sum_relu_kernel`` (``csrc/sum_relu.cu``); on CPU
tensors they run ``pool_plain`` and ``sum_relu_plain``. ``conv_relu_pool``
runs ``ConvPoolOp`` (``ops/convpool.py``) where ``pool2_fusable`` holds and
``conv`` followed by ``pool`` elsewhere.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..config import ConvConfig, PoolConfig
from ..types import dtype, round_mode
from ..utils.device import as_tensor
from ..utils.logger import check, check_eq
from ..utils.mathutil import conv_output_size
from .requant import relu_f32, round_f32, saturate

_POOL_KINDS = {"max": 0, "avg_inc": 1, "avg_exc": 2}


def _identity_pad(pc: PoolConfig, dt: dtype):
    if pc.kind == "max":
        return {dtype.u8: 0, dtype.s8: -128, dtype.s32: -(2 ** 31),
                dtype.f32: float("-inf")}[dt]
    return 0


def avg_exc_inv_counts(pc: PoolConfig) -> np.ndarray:
    """Per-output reciprocal of the in-image tap count, (oh, ow) f32,
    computed exactly as ``deepfusion_tpu/ops/pool.py:104-114``."""
    ones = np.zeros((pc.ih + pc.ph + pc.pb, pc.iw + pc.pw + pc.pr),
                    np.int32)
    ones[pc.ph:pc.ph + pc.ih, pc.pw:pc.pw + pc.iw] = 1
    cnt = np.zeros((pc.oh, pc.ow), np.int32)
    for ki in range(pc.kh):
        for kj in range(pc.kw):
            hs = slice(ki, ki + (pc.oh - 1) * pc.sh + 1, pc.sh)
            ws = slice(kj, kj + (pc.ow - 1) * pc.sw + 1, pc.sw)
            cnt += ones[hs, ws]
    return (1.0 / cnt).astype(np.float32)


def avg_inc_inv(pc: PoolConfig) -> np.float32:
    """The f32 reciprocal of kh*kw. The JAX kernel writes ``sum / (kh*kw)``,
    and XLA compiles a division by a constant as a multiplication by its
    f32 reciprocal; the port multiplies by the same constant."""
    return np.float32(1.0) / np.float32(pc.kh * pc.kw)


def _wrap_s32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the JAX kernel's int32
    sums wrap)."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def pool_plain(x: torch.Tensor, pc: PoolConfig, dt: dtype) -> torch.Tensor:
    """The plain PyTorch version of ``pool_kernel``: identity padding, taps
    taken in (ki, kj) order, f32 sums added one by one."""
    pad = _identity_pad(pc, dt)
    work = x.to(torch.int64) if dt.is_int else x
    xp = F.pad(work, (0, 0, pc.pw, pc.pr, pc.ph, pc.pb), value=pad)
    acc = None
    for ki in range(pc.kh):
        for kj in range(pc.kw):
            tap = xp[:, ki:ki + (pc.oh - 1) * pc.sh + 1:pc.sh,
                     kj:kj + (pc.ow - 1) * pc.sw + 1:pc.sw, :]
            if acc is None:
                acc = tap
            elif pc.kind == "max":
                acc = torch.maximum(acc, tap)
            else:
                acc = acc + tap
    if pc.kind == "max":
        return acc.to(dt.torch)
    f = _wrap_s32(acc).to(torch.float32) if dt.is_int else acc
    if pc.kind == "avg_inc":
        val = f * torch.full_like(f, float(avg_inc_inv(pc)))
    else:
        inv = torch.from_numpy(avg_exc_inv_counts(pc)).to(x.device)
        val = f * inv[None, :, :, None]
    if not dt.is_int:
        return val
    return saturate(round_f32(val, pc.round), dt)


def _pool_geo(pc: PoolConfig) -> tuple:
    """The pool's ints as ``torch.ops.deepfusion_torch.pool`` takes them
    (``csrc/torch_ops.cpp``, ``PoolGeo``)."""
    return (pc.ih, pc.iw, pc.oh, pc.ow, pc.kh, pc.kw, pc.sh, pc.sw, pc.ph,
            pc.pw, _POOL_KINDS[pc.kind], int(pc.round == round_mode.down))


def pool_cuda(x: torch.Tensor, pc: PoolConfig, dt: dtype) -> torch.Tensor:
    """Launch ``pool_kernel`` (or its vector or cluster-split kind) on the
    current stream through ``torch.ops.deepfusion_torch.pool``, which
    checks, aligns, allocates and launches in C++; the output has x's
    dtype, ``dt``."""
    out = _build.op("pool")(x, _pool_geo(pc))
    _build.count_launch("pool")
    return out


def pool(x, kind: str, kernel, stride, padding,
         round=round_mode.nearest, *, ceil_mode=True,
         device=None) -> torch.Tensor:
    """Standalone max / avg_inc / avg_exc pooling over NHWC (any supported
    dtype); integer averages round with `round` and saturate. The output
    size is ceil mode's, or the floor rule's without ``ceil_mode``
    (``PoolConfig.make``). ``x`` is a tensor (the pool runs on its device)
    or a numpy array, which goes to ``device``: by default the current CUDA
    device, ``"cpu"`` for the plain PyTorch version."""
    x = as_tensor(x, device)
    check_eq(x.dim(), 4, "pool input must be NHWC")
    dt = dtype.from_any(x.dtype)
    pc = PoolConfig.make(kind, (x.shape[1], x.shape[2]), kernel, stride,
                         padding, round, ceil_mode)
    if x.device.type == "cpu":
        return pool_plain(x, pc, dt)
    return pool_cuda(x, pc, dt)


def sum_relu_plain(a: torch.Tensor, b: torch.Tensor, dt: dtype,
                   with_relu: bool) -> torch.Tensor:
    """The plain PyTorch version of ``sum_relu_kernel``."""
    if dt == dtype.f32:
        s = a + b
        return relu_f32(s) if with_relu else s
    s = a.to(torch.int64) + b.to(torch.int64)
    if with_relu:
        s = s.clamp_min(0)
    lo, hi = {dtype.s32: (-2 ** 31, 2 ** 31 - 1), dtype.s8: (-128, 127),
              dtype.u8: (0, 255)}[dt]
    return s.clamp(lo, hi).to(dt.torch)


def sum_relu_cuda(a: torch.Tensor, b: torch.Tensor, dt: dtype,
                  with_relu: bool) -> torch.Tensor:
    """Launch ``sum_relu_kernel`` on the current stream through
    ``torch.ops.deepfusion_torch.sum_relu``, which checks, aligns,
    allocates and launches in C++; ``dt`` is the operands' dtype."""
    out = _build.op("sum_relu")(a, b, with_relu)
    _build.count_launch("sum_relu")
    return out


def eltwise_sum_relu(a, b, with_relu: bool = True, *,
                     device=None) -> torch.Tensor:
    """Fused elementwise sum + ReLU (roadmap op, README.md:64-65): integer
    dtypes add in wide integers and saturate back; f32 adds in f32. Numpy
    operands go to ``device`` (as ``pool``'s)."""
    a, b = as_tensor(a, device), as_tensor(b, device)
    check_eq(tuple(a.shape), tuple(b.shape), "eltwise operand shapes")
    check_eq(a.dtype, b.dtype, "eltwise operand dtypes")
    check(a.device == b.device, "eltwise operands must share a device")
    dt = dtype.from_any(a.dtype)
    if a.device.type == "cpu":
        return sum_relu_plain(a, b, dt, with_relu)
    return sum_relu_cuda(a, b, dt, with_relu)


def conv_relu_pool(src, wei, bia, stride, padding, *, dst_dtype,
                   conv_scales=(1.0,), conv_relu=True,
                   conv_round_mode=round_mode.nearest,
                   pool_kind="max", pool_kernel=(2, 2), pool_stride=(2, 2),
                   pool_padding=(0, 0), pool_round_mode=round_mode.nearest,
                   device=None):
    """Fused conv+ReLU+pooling, NHWC u8 in (``deepfusion_tpu/ops/pool.py:
    conv_relu_pool``): one ``convpool_kernel`` for the 2x2/s2 geometries
    ``pool2_fusable`` admits, the conv then the pool otherwise. ``src`` is a
    tensor (the op runs on its device) or a numpy array, which goes to
    ``device`` (as ``pool``'s)."""
    from .conv import conv
    from .convpool import ConvPoolOp, pool2_fusable

    src = as_tensor(src, device)
    wei = np.asarray(wei)
    n, ih, iw, ic = src.shape
    oc, _, kh, kw = wei.shape
    oh = conv_output_size(ih, kh, stride[0], padding[0])
    ow = conv_output_size(iw, kw, stride[1], padding[1])
    cfg = ConvConfig.make(
        (n, ih, iw, ic), tuple(wei.shape),
        None if bia is None else np.asarray(bia).dtype,
        stride, padding, (n, oh, ow, oc), dst_dtype,
        conv0_relu=conv_relu, conv0_scales=conv_scales,
        conv0_round=conv_round_mode)
    pc = PoolConfig.make(pool_kind, (oh, ow), pool_kernel, pool_stride,
                         pool_padding, pool_round_mode)
    if pool2_fusable(cfg, pc):
        return ConvPoolOp(cfg, pc, wei, bia, device=src.device)(src)
    out = conv(src, wei, bia, stride, padding, dst_dtype=dst_dtype,
               conv0_relu=conv_relu, conv0_scales=conv_scales,
               conv0_round_mode=conv_round_mode)
    return pool(out, pool_kind, pool_kernel, pool_stride, pool_padding,
                pool_round_mode)
