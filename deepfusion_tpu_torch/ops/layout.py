"""Weight layouts of the conv kernel, and the epilogue vectors.

The kernel (``csrc/conv.cu``) multiplies u8 activations by s8 weights on
the tensor cores (``mma.sync`` m16n8k32), whose fragments hold 4 8-bit
values of consecutive K (input channels) per register, so a weight matrix
is stored as int32 words of 4 s8 values taken along the input channels:

    pack_conv_weights: OIHW (oc, ic, kh, kw) -> int32 [kh*kw][icp/4][ocp]
        word [t, k, o] holds w[o, 4k+b, t // kw, t % kw] in byte b
    pack_1x1_weights:  (oc1, ic, 1, 1)       -> int32 [icp/4][ocp]

with ``icp`` = ic rounded up to 32 (one mma k-step) for the conv and
``fused_k(oc0p)``, the intermediate's ``oc0p`` channels rounded up to 32,
for the 1x1, and ``ocp`` = oc rounded up to 8 (one mma n-tile). Padding is
zero.

Zero padding of the image is exact in the u8 domain, so the JAX package's
-128 shift of the activations and its correction term are not needed here.

The packed-domain conv (``csrc/packed_conv.cu``) uses the same word layouts
with wider padding: K is the sum of its sources' lanes (``conv_icp(ic)``,
since every source but the last has ``cp == c``, OIHW with ic = c0 + c1 + ...
is already in the lane order of the joined sources) and every N is
``packed_cp(oc)``, the lane count of the packed output
(``deepfusion_tpu/ops/packed.py:_narrow_cfg``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.mathutil import round_up

IC_ALIGN = 32   # K of one mma.sync m16n8k32 step
OC_ALIGN = 8    # N of one mma.sync m16n8k32 tile


def conv_icp(ic: int) -> int:
    return round_up(ic, IC_ALIGN)


def conv_ocp(oc: int) -> int:
    return round_up(oc, OC_ALIGN)


def packed_cp(c: int) -> int:
    """Lanes of a packed image of c channels: c rounded up to 32, at least
    32."""
    return max(round_up(c, IC_ALIGN), IC_ALIGN)


def fused_k(oc0p: int) -> int:
    """K of the fused 1x1: the intermediate's channels, rounded up to 32."""
    return round_up(oc0p, IC_ALIGN)


def _words(w_kio: np.ndarray) -> np.ndarray:
    """(..., icp, ocp) int8 -> (..., icp/4, ocp) int32, 4 channels a word."""
    *lead, icp, ocp = w_kio.shape
    w = w_kio.reshape(*lead, icp // 4, 4, ocp)
    w = np.ascontiguousarray(np.moveaxis(w, -2, -1))   # (..., icp/4, ocp, 4)
    return w.view("<i4").reshape(*lead, icp // 4, ocp)


def pack_conv_weights(wei_oihw: np.ndarray, icp: int, ocp: int) -> np.ndarray:
    """OIHW s8 -> int32 words [kh*kw][icp/4][ocp] (see module docstring)."""
    w = np.asarray(wei_oihw, dtype=np.int8)
    oc, ic, kh, kw = w.shape
    out = np.zeros((kh, kw, icp, ocp), dtype=np.int8)
    out[:, :, :ic, :oc] = np.transpose(w, (2, 3, 1, 0))
    return _words(out.reshape(kh * kw, icp, ocp))


def pack_1x1_weights(wei_oihw: np.ndarray, icp: int, ocp: int) -> np.ndarray:
    """(OC1, IC, 1, 1) s8 -> int32 words [icp/4][ocp]."""
    w = np.asarray(wei_oihw, dtype=np.int8)
    oc1, ic = w.shape[0], w.shape[1]
    out = np.zeros((icp, ocp), dtype=np.int8)
    out[:ic, :oc1] = w.reshape(oc1, ic).T
    return _words(out)


def unpack_weights(words: torch.Tensor, oc: int, ic: int, kh: int,
                   kw: int) -> torch.Tensor:
    """Inverse of the packers: int32 words -> OIHW int8 (oc, ic, kh, kw).
    The plain PyTorch conv reads its weights through this, so it runs on
    the very operands the kernel gets."""
    w = words.reshape(kh * kw, -1, words.shape[-1]).contiguous()
    t, k4, ocp = w.shape
    b = w.view(torch.int8).reshape(t, k4, ocp, 4)      # little-endian bytes
    b = b.permute(2, 1, 3, 0).reshape(ocp, k4 * 4, kh, kw)
    return b[:oc, :ic].contiguous()


def widen_bias(bias, ocp: int) -> np.ndarray:
    """Bias of any dtype widened to f32 and zero-padded to ocp; every
    integer bias the reference takes is exact in f32
    (``src/jit_conv_kernel.cc:238-254``)."""
    out = np.zeros((ocp,), dtype=np.float32)
    if bias is not None:
        b = np.asarray(bias).reshape(-1).astype(np.float32)
        out[:b.size] = b
    return out


def widen_scales(scales, oc: int, ocp: int) -> np.ndarray:
    """Scalar or per-channel scales -> per-channel f32, padded with 1.0."""
    sc = np.asarray(scales, dtype=np.float32).reshape(-1)
    out = np.ones((ocp,), dtype=np.float32)
    out[:oc] = sc if sc.size > 1 else np.full((oc,), sc[0], np.float32)
    return out
