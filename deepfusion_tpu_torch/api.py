"""Object-style public API: ``memory`` + ``op`` + factory functions.

The PyTorch counterpart of ``deepfusion_tpu/api.py``, with the reference's
call shapes (``include/deepfusion.h:105-145``): a factory validates and
builds an op object; ``op.submit()`` runs inference, reading its inputs
from ``memory`` containers and writing the result into one, timed when
``DEEPFUSION_PROFILE`` is set (``src/deepfusion.cc:90-103``,
``utils/profiler.py``).

Each factory takes ``device=None``, the device rule of ``utils/device.py``:
the op runs on the current CUDA device unless it is given another one
(``"cpu"`` for the plain PyTorch versions). ``infer()`` hands the
functional ops (``deepfusion_tpu_torch.ops``) tensors on the op's device:
host data in a ``memory`` is uploaded there once and stays in the
``memory`` (``memory.tensor``), results stay on the device as torch
tensors, so chained ops feed each other with no host round trip, and
``memory.numpy()`` is the explicit host copy. A ``memory`` holding a tensor
on another device raises: a CUDA op never takes the plain path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .config import ConcatConfig, ConvConfig, PoolConfig
from .ops.concat import concat as concat_fn
from .ops.conv import ConvOp
from .ops.pool import eltwise_sum_relu as eltwise_sum_relu_fn
from .ops.pool import pool as pool_fn
from .types import memory, round_mode
from .utils.device import default_device
from .utils.logger import check, check_eq
from .utils.profiler import submit_timer


def _op_device(device) -> torch.device:
    """default_device(device), with the index of the current CUDA device
    where a CUDA device names none, so that it compares equal to the
    device of the tensors the op makes."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class op:
    """Abstract op with profiled submit (``include/deepfusion.h:105-114``).
    ``device``: where the op runs."""

    device: torch.device

    def submit(self):
        with submit_timer(self.name(), self.device):
            self.infer()

    def infer(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class _concat_op(op):
    def __init__(self, srcs: Sequence[memory], dst: memory, post_relu: bool,
                 device):
        # validate against dst (the factory's switch on the dst dtype,
        # src/deepfusion.cc:105-121)
        cfg = ConcatConfig.make([tuple(s.actual_dims()) for s in srcs],
                                dst.data_type(), post_relu)
        check_eq(dst.actual_dims()[-1], cfg.oc, "dst channels")
        for s in srcs:
            check_eq(s.data_type(), dst.data_type(),
                     "concat src/dst dtype must match")
        self._srcs, self._dst, self._relu = list(srcs), dst, post_relu
        self.device = _op_device(device)

    def infer(self):
        self._dst.data = concat_fn([s.tensor(self.device)
                                    for s in self._srcs], self._relu)


class _conv_op(op):
    def __init__(self, src, wei, bia, sz_stride, sz_padding, dst,
                 conv0_relu, conv0_scales, conv0_round_mode,
                 wei1x1=None, bia1x1=None, conv1_relu=False,
                 conv1_scales=(1.0,), conv1_round_mode=round_mode.nearest,
                 device=None):
        wei_dims = wei.std_dims()  # oihw
        cfg = ConvConfig.make(
            tuple(src.actual_dims()), tuple(wei_dims),
            None if bia is None else bia.data_type(),
            tuple(sz_stride), tuple(sz_padding), tuple(dst.actual_dims()),
            dst.data_type(),
            conv0_relu=conv0_relu, conv0_scales=conv0_scales,
            conv0_round=conv0_round_mode,
            wei1x1_shape=None if wei1x1 is None else tuple(wei1x1.std_dims()),
            bia1x1_dt=None if bia1x1 is None else bia1x1.data_type(),
            conv1_relu=conv1_relu, conv1_scales=conv1_scales,
            conv1_round=conv1_round_mode)
        self._src, self._dst = src, dst
        self.device = _op_device(device)
        self._impl = ConvOp(
            cfg, wei.numpy().reshape(wei_dims),
            None if bia is None else bia.numpy(),
            None if wei1x1 is None else wei1x1.numpy().reshape(
                wei1x1.std_dims()),
            None if bia1x1 is None else bia1x1.numpy(), device=self.device)

    def infer(self):
        self._dst.data = self._impl(self._src.tensor(self.device))


class _pool_op(op):
    def __init__(self, src, dst, kind, kernel, stride, padding, rnd, device):
        n, ih, iw, c = src.actual_dims()
        pc = PoolConfig.make(kind, (ih, iw), kernel, stride, padding, rnd)
        check_eq(tuple(dst.actual_dims()), (n, pc.oh, pc.ow, c),
                 "pool dst dims")
        check_eq(src.data_type(), dst.data_type(), "pool dtype")
        self._src, self._dst = src, dst
        self._args = (kind, kernel, stride, padding, rnd)
        self.device = _op_device(device)

    def infer(self):
        self._dst.data = pool_fn(self._src.tensor(self.device), *self._args)


class _eltwise_sum_relu_op(op):
    def __init__(self, a, b, dst, with_relu, device):
        check_eq(a.actual_dims(), b.actual_dims(), "eltwise dims")
        check_eq(a.data_type(), dst.data_type(), "eltwise dtype")
        self._a, self._b, self._dst, self._relu = a, b, dst, with_relu
        self.device = _op_device(device)

    def infer(self):
        self._dst.data = eltwise_sum_relu_fn(self._a.tensor(self.device),
                                             self._b.tensor(self.device),
                                             self._relu)


def concat(srcs: Sequence[memory], dst: memory, post_relu: bool = False, *,
           device=None) -> op:
    """Factory (``include/deepfusion.h:116-118``)."""
    return _concat_op(srcs, dst, post_relu, device)


def pool(src: memory, dst: memory, kind: str = "max", kernel=(2, 2),
         stride=(2, 2), padding=(0, 0), round_mode_=round_mode.nearest, *,
         device=None) -> op:
    """Pooling factory (roadmap op; spec ``test_conv_relu_pooling.cc``)."""
    return _pool_op(src, dst, kind, kernel, stride, padding, round_mode_,
                    device)


def eltwise_sum_relu(a: memory, b: memory, dst: memory,
                     with_relu: bool = True, *, device=None) -> op:
    """Eltwise-sum+ReLU factory (roadmap op, ``README.md:64-65``)."""
    return _eltwise_sum_relu_op(a, b, dst, with_relu, device)


def conv(src: memory, wei: memory, bia: Optional[memory],
         sz_stride, sz_padding, *args, device=None, **kwargs) -> op:
    """Factories (``include/deepfusion.h:120-145``).

    Two call shapes, like the reference:
      conv(src, wei, bia, stride, pad, dst, conv0_relu, conv0_scales,
           conv0_round_mode)
      conv(src, wei, bia, stride, pad, wei1x1, bia1x1, dst, conv0_relu,
           conv0_scales, conv0_round_mode, conv1_relu, conv1_scales,
           conv1_round_mode)

    The overload is resolved as the C++ compiler resolves the reference's
    two signatures, by the type at each position, checked both ways so a
    malformed call raises instead of mis-dispatching: the fused shape has a
    ``memory`` (dst) at position 2 after a ``memory`` wei1x1 and a
    ``memory``/None bia1x1; the plain shape has a ``memory`` dst at
    position 0 followed only by non-memory extras.
    """
    def is_mem(a):
        return isinstance(a, memory)

    def extra(rest, i, key, default):
        return rest[i] if len(rest) > i else kwargs.get(key, default)

    fused = (len(args) >= 3 and is_mem(args[2])) or \
        (len(args) == 2 and is_mem(args[0]) and "dst" in kwargs) or \
        ("wei1x1" in kwargs)
    if fused:
        wei1x1 = args[0] if args else kwargs.pop("wei1x1")
        bia1x1 = args[1] if len(args) >= 2 else kwargs.pop("bia1x1", None)
        dst = args[2] if len(args) >= 3 else kwargs.pop("dst")
        rest = list(args[3:])
        check(is_mem(wei1x1) and is_mem(dst)
              and (bia1x1 is None or is_mem(bia1x1)),
              "fused conv call shape: (..., wei1x1: memory, "
              "bia1x1: memory|None, dst: memory, ...)")
        check(not any(is_mem(a) for a in rest),
              "unexpected memory operand after dst in fused conv call")
        return _conv_op(
            src, wei, bia, sz_stride, sz_padding, dst,
            extra(rest, 0, "conv0_relu", False),
            extra(rest, 1, "conv0_scales", (1.0,)),
            extra(rest, 2, "conv0_round_mode", round_mode.nearest),
            wei1x1, bia1x1,
            extra(rest, 3, "conv1_relu", False),
            extra(rest, 4, "conv1_scales", (1.0,)),
            extra(rest, 5, "conv1_round_mode", round_mode.nearest),
            device=device)
    dst = args[0] if args else kwargs.pop("dst")
    rest = list(args[1:])
    check(is_mem(dst), "conv call shape: dst must be a memory")
    check(not any(is_mem(a) for a in rest),
          "unexpected memory operand after dst in conv call (fused calls "
          "pass wei1x1, bia1x1, dst in that order)")
    return _conv_op(src, wei, bia, sz_stride, sz_padding, dst,
                    extra(rest, 0, "conv0_relu", False),
                    extra(rest, 1, "conv0_scales", (1.0,)),
                    extra(rest, 2, "conv0_round_mode", round_mode.nearest),
                    device=device)
