"""Core types: element dtypes, layouts and rounding modes.

The PyTorch counterpart of ``deepfusion_tpu.types``. Activations are NHWC at
every public function, as in the JAX package. Each dtype maps to both its
numpy and its torch dtype; the integer codes are the ones the CUDA kernels
take (``csrc/requant.cuh``, ``DT_*``).
"""
from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch


class dtype(enum.Enum):
    """Supported element types (reference: ``include/deepfusion.h:66-72``)."""

    undef = 0
    f32 = 1
    s32 = 2
    s8 = 3
    u8 = 4

    @property
    def np(self) -> np.dtype:
        return _DTYPE_TO_NP[self]

    @property
    def torch(self) -> torch.dtype:
        return _DTYPE_TO_TORCH[self]

    @property
    def size(self) -> int:
        return _DTYPE_TO_NP[self].itemsize

    @property
    def is_int(self) -> bool:
        return self in (dtype.s32, dtype.s8, dtype.u8)

    @classmethod
    def from_any(cls, dt: "DTypeLike") -> "dtype":
        if isinstance(dt, cls):
            return dt
        if isinstance(dt, torch.dtype):
            for k, v in _DTYPE_TO_TORCH.items():
                if v == dt:
                    return k
            raise ValueError(f"unsupported dtype: {dt!r}")
        if isinstance(dt, str):
            try:
                return cls[dt]
            except KeyError:
                pass
        npdt = np.dtype(dt)
        for k, v in _DTYPE_TO_NP.items():
            if v == npdt:
                return k
        raise ValueError(f"unsupported dtype: {dt!r}")


_DTYPE_TO_NP = {
    dtype.f32: np.dtype(np.float32),
    dtype.s32: np.dtype(np.int32),
    dtype.s8: np.dtype(np.int8),
    dtype.u8: np.dtype(np.uint8),
}

_DTYPE_TO_TORCH = {
    dtype.f32: torch.float32,
    dtype.s32: torch.int32,
    dtype.s8: torch.int8,
    dtype.u8: torch.uint8,
}

DTypeLike = Union[dtype, str, np.dtype, torch.dtype, type]

f32 = dtype.f32
s32 = dtype.s32
s8 = dtype.s8
u8 = dtype.u8


class format(enum.Enum):
    """Layouts (reference: ``include/deepfusion.h:53-61``). Activations are
    ``nhwc``; ``mma_pack`` is the conv weight layout of
    ``ops/layout.py:pack_conv_weights``."""

    undef = 0
    x = 1
    nchw = 2
    oihw = 2
    nhwc = 3
    mma_pack = 6


class round_mode(enum.Enum):
    """Requantization rounding (reference: ``include/deepfusion.h:46-49``):
    ``nearest`` is round-half-to-even, ``down`` rounds toward -inf."""

    nearest = 0
    down = 1

    @classmethod
    def from_any(cls, rm: "RoundModeLike") -> "round_mode":
        if isinstance(rm, cls):
            return rm
        return cls[str(rm)]


RoundModeLike = Union[round_mode, str]
