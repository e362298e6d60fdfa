"""Core types: element dtypes, layouts, rounding modes and the object
API's tensor container ``memory``.

The PyTorch counterpart of ``deepfusion_tpu.types``. Activations are NHWC at
every public function, as in the JAX package. Each dtype maps to both its
numpy and its torch dtype; the integer codes are the ones the CUDA kernels
take (``csrc/requant.cuh``, ``DT_*``).
"""
from __future__ import annotations

import enum
from typing import Optional, Sequence, Union

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
    ``ops/layout.py:pack_conv_weights``. ``nchw``/``oihw`` (and the
    reference's weight layouts, accepted for API parity) describe logical
    dims that ``memory`` permutes to the physical order (``nchw2format``).
    """

    undef = 0
    x = 1
    nchw = 2
    oihw = 2
    nhwc = 3
    OIhw4i16o4i = 4  # accepted for API parity; weights stay logical OIHW
    gOIhw4i16o4i = 5
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


def nchw2format(nchw_dims: Sequence[int], fmt: format) -> list:
    """Permute logical-NCHW dims to the physical layout's dim order
    (``src/deepfusion.cc:25-57``)."""
    n, c, h, w = nchw_dims
    if fmt == format.nchw:
        return [n, c, h, w]
    if fmt == format.nhwc:
        return [n, h, w, c]
    if fmt in (format.OIhw4i16o4i, format.mma_pack):
        # logical oihw; the ops pack weights themselves (ops/layout.py)
        return [n, c, h, w]
    if fmt == format.x:
        return list(nchw_dims)
    raise ValueError(f"unsupported format {fmt}")


class memory:
    """Tensor container of the object API: data + dims + layout + dtype.

    Reference parity: ``deepfusion::memory`` (``include/deepfusion.h:51-103``).
    Constructed from ``nchw_dims`` (logical, permuted like the reference)
    or from raw ``dims`` in the physical layout. ``data`` holds a host
    numpy array (zeros, ``fill_random`` or an assigned array) until an op
    reads it: the op uploads it to its device once (``tensor``), and from
    then on, as for every op result, it holds a torch tensor on that
    device. ``numpy()`` is the explicit host copy.
    """

    def __init__(self, dims: Sequence[int], fmt: format, dt: DTypeLike,
                 *, nchw: Optional[bool] = None, data=None):
        dt = dtype.from_any(dt)
        dims = [int(d) for d in dims]
        if nchw is None:
            nchw = len(dims) == 4 and fmt in (
                format.nchw, format.nhwc, format.OIhw4i16o4i,
                format.mma_pack)
        self._std_dims = list(dims)  # nchw or oihw when nchw
        if nchw and len(dims) == 4:
            dims = nchw2format(dims, fmt)
        self._dims = dims
        self._fmt = fmt
        self._dt = dt
        self._data = np.zeros(dims, dtype=dt.np) if data is None else data

    # --- reference-parity accessors (include/deepfusion.h:86-92) ---
    def size(self) -> int:
        return int(np.prod(self._dims))

    def buffer_size(self) -> int:
        return self.size() * self._dt.size

    def actual_dims(self) -> list:
        return list(self._dims)

    def std_dims(self) -> list:
        return list(self._std_dims)

    def data_type(self) -> dtype:
        return self._dt

    def dim_format(self) -> format:
        return self._fmt

    @property
    def data(self):
        """A host numpy array, or a torch tensor on an op's device."""
        return self._data

    @data.setter
    def data(self, value):
        if isinstance(value, (list, tuple, np.ndarray)):
            value = np.asarray(value, dtype=self._dt.np)
        if tuple(value.shape) != tuple(self._dims):
            raise ValueError(
                f"shape mismatch: memory dims {self._dims}, got "
                f"{tuple(value.shape)}")
        self._data = value

    def tensor(self, device) -> torch.Tensor:
        """The data as a tensor on ``device``, for an op of that device: host
        data is uploaded once and kept here; a tensor on another device
        raises (an op never moves one between devices, nor takes the CPU
        path for a CUDA op)."""
        device = torch.device(device)
        if not isinstance(self._data, torch.Tensor):
            self._data = torch.as_tensor(np.asarray(self._data),
                                         device=device)
        if self._data.device != device:
            raise ValueError(
                f"memory holds a tensor on {self._data.device}; the op runs "
                f"on {device}")
        return self._data

    def numpy(self) -> np.ndarray:
        """The data as a host numpy array (a copy for a device tensor)."""
        if isinstance(self._data, torch.Tensor):
            return self._data.detach().cpu().numpy()
        return np.asarray(self._data)

    def fill_random(self, rng: Optional[np.random.Generator] = None):
        """Test-style host data fill (reference: ``test/test_utils.h:49-63``),
        the JAX package's draw exactly: one numpy seed gives both packages
        the same data."""
        rng = rng or np.random.default_rng()
        if self._dt == dtype.f32:
            i = np.arange(self.size(), dtype=np.float32).reshape(self._dims)
            self._data = (1.0 + 0.01 * np.sin(i % 37)).astype(np.float32)
        elif self._dt == dtype.u8:
            self._data = rng.integers(0, 17, self._dims, dtype=np.uint8)
        else:
            self._data = rng.integers(-10, 11,
                                      self._dims).astype(self._dt.np)
        return self
