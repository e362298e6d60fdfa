"""Weight layouts of the conv kernels, and the epilogue vectors.

The kernels multiply u8 activations by s8 weights on the tensor cores. The
operands (what ``save``/``load`` keep, in the JAX package's layout) are
int32 words of 4 s8 values taken along the input channels:

    pack_conv_weights: OIHW (oc, ic, kh, kw) -> int32 [kh*kw][icp/4][ocp]
        word [t, k, o] holds w[o, 4k+b, t // kw, t % kw] in byte b
    pack_1x1_weights:  (oc1, ic, 1, 1)       -> int32 [icp/4][ocp]

with ``icp`` = ic rounded up to 32 (one k-step) for the conv and
``fused_k(oc0p)``, the intermediate's ``oc0p`` channels rounded up to 32,
for the 1x1, and ``ocp`` = oc rounded up to 8 (one n-tile). Padding is
zero.

The dense conv kernel (``csrc/conv.cu``, with its pool mode for
``ConvPoolOp``) runs wgmma, which takes 8-bit operands K-major only:
``dense_kmajor_weights`` derives its (N, K) int8 matrices from the words.
Its zero padding is exact in the u8 domain, so it needs neither the JAX
package's -128 shift of the activations nor its correction term.

The packed-domain conv (``ops/packed.py``, and the conv pair of
``ops/mega.py``, which reads its two ``PackedConvOp``s' copies) keeps the
same word layouts with wider padding: K is the sum of its sources' lanes
(``conv_icp(ic)``, since every source but the last has ``cp == c``, OIHW
with ic = c0 + c1 + ... is already in the lane order of the joined
sources) and every N is
``packed_cp(oc)``, the lane count of the packed output
(``deepfusion_tpu/ops/packed.py:_narrow_cfg``). Its kernel
(``csrc/packed_conv.cu``) runs wgmma, which takes 8-bit operands K-major
only, on the stored bytes read as s8: ``kmajor_weights`` derives its
(N, K) int8 matrices from the words, K in the order the kernel walks, and
``u8_shift_correction`` the exact correction the JAX package adds
(``deepfusion_tpu/ops/layout.py:u8_shift_correction``):

    conv_u8s8(x, w) = conv_s8s8(x - 128, w) + 128 * sum_{taps, k} w

exact in int32 for every stored byte, pads included, because a stored
byte b is u8 - 128 whatever u8 is.

The space-to-depth helpers (``s2d_*``) serve the packed strided conv only:
its input spec describes the packed s2d image, so its specs compare one to
one with the JAX package's, and it runs as a stride-1 conv on that grid.
The dense kernels take stride in their addressing and never use them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ConvConfig
from ..utils.mathutil import round_up

IC_ALIGN = 32   # K bytes of one wgmma k-step
OC_ALIGN = 8    # N granule of wgmma


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


def source_k(cp: int) -> int:
    """K bytes the packed conv kernel gives a source of cp lanes: cp rounded
    up to 32, one wgmma k-step (the lanes past cp read zeros against zero
    weights)."""
    return round_up(cp, IC_ALIGN)


def kmajor_weights(words: torch.Tensor, kh: int, kw: int,
                   cps) -> torch.Tensor:
    """The packed conv kernel's B operand: int32 words [kh*kw][icp/4][ocp]
    (``pack_conv_weights``, or ``pack_1x1_weights`` with kh = kw = 1) ->
    int8 (ocp, kh*kw*KP) on the words' device, row o holding output channel
    o's weights with K in the kernel's order: tap t = ki*kw + kj, then each
    source's cp lanes padded with zeros to ``source_k(cp)``; KP is the sum
    of those."""
    ocp = words.shape[-1]
    w = unpack_weights(words, ocp, sum(cps), kh, kw)     # (ocp, icp, kh, kw)
    w = w.permute(0, 2, 3, 1).reshape(ocp, kh * kw, -1)
    parts, off = [], 0
    for cp in cps:
        parts.append(F.pad(w[..., off:off + cp], (0, source_k(cp) - cp)))
        off += cp
    return torch.cat(parts, dim=-1).reshape(ocp, -1).contiguous()


def dense_kmajor_weights(words: torch.Tensor, kh: int,
                         kw: int) -> torch.Tensor:
    """The dense conv kernel's B operand: int32 words [kh*kw][icp/4][ocp]
    (``pack_conv_weights``) or [k1/4][ocp] (``pack_1x1_weights``, kh = kw
    = 1) -> int8 (ocp, kh*kw*icp) on the words' device: row o holds output
    channel o's weights, K tap by tap (t = ki*kw + kj), each tap's icp
    channels, zero past ic (and past oc0 in the 1x1's k1)."""
    return kmajor_weights(words, kh, kw, [words.shape[-2] * 4])


def unfold_icp(kw: int, ic: int) -> int:
    """The channels of a conv's input with its kw column taps folded into
    them (``ops/conv.py: unfold_cols``): kw * ic rounded up to one k-step."""
    return round_up(kw * ic, IC_ALIGN)


def unfolded_kmajor_weights(words: torch.Tensor, kh: int, kw: int,
                            ic: int) -> torch.Tensor:
    """The dense conv kernel's B operand for the conv run as kh x 1 over
    the unfolded input: int32 words [kh*kw][icp/4][ocp]
    (``pack_conv_weights``) -> int8 (ocp, kh * unfold_icp(kw, ic)) on the
    words' device: row o, tap ki, channel kj * ic + c holds w[o, c, ki,
    kj], zero past kw * ic."""
    ocp = words.shape[-1]
    w = unpack_weights(words, ocp, ic, kh, kw)            # (ocp, ic, kh, kw)
    w = w.permute(0, 2, 3, 1).reshape(ocp, kh, kw * ic)
    return F.pad(w, (0, unfold_icp(kw, ic) - kw * ic)).reshape(
        ocp, -1).contiguous()


def u8_shift_correction(wk: torch.Tensor) -> torch.Tensor:
    """Per-output-channel exact correction, int32: 128 * the row sum of a
    K-major (N, K) int8 weight matrix. Added to the accumulator of the
    stored bytes read as s8, it gives the u8-activation accumulator. The
    JAX package's function sums the columns of its (K, N) matrix: the same
    sums over another row order."""
    return 128 * wk.to(torch.int32).sum(dim=1, dtype=torch.int32)


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


# ------------------------------------------------------------ strided
# Space-to-depth: a stride-(sh, sw) conv is exactly a stride-1 conv over the
# (sh*sw*ic)-channel s2d grid with remapped weights. Original tap (ki, kj)
# lands at s2d tap (ki // sh, kj // sw) in lane group g = (ki % sh) * sw +
# (kj % sw); s2d slots with no original tap get zero weights. Copies of
# deepfusion_tpu/ops/layout.py:144-226.


def s2d_taps(cfg: ConvConfig) -> Tuple[int, int]:
    """Kernel extent of the stride-1 equivalent on the s2d grid."""
    return (cfg.kh - 1) // cfg.sh + 1, (cfg.kw - 1) // cfg.sw + 1


def s2d_cfg(cfg: ConvConfig) -> ConvConfig:
    """The stride-1 ConvConfig equivalent to a strided `cfg` on the s2d
    grid: output geometry, dtypes, scales, fusion and post-ops carry over;
    only the input side is re-expressed."""
    kh2, kw2 = s2d_taps(cfg)
    ic2 = cfg.sh * cfg.sw * cfg.ic
    ih2 = cfg.oh + kh2 - 1
    iw2 = cfg.ow + kw2 - 1
    return ConvConfig.make(
        (cfg.bs, ih2, iw2, ic2), (cfg.oc, ic2, kh2, kw2), cfg.bia_dt,
        (1, 1), (0, 0), (cfg.bs, cfg.oh, cfg.ow, cfg.out_oc), cfg.dst_dt,
        conv0_relu=cfg.conv0_relu, conv0_scales=cfg.conv0_scales,
        conv0_round=cfg.conv0_round,
        wei1x1_shape=(cfg.oc1x1, cfg.oc, 1, 1) if cfg.fuse_conv1x1 else None,
        bia1x1_dt=cfg.bia1x1_dt, conv1_relu=cfg.conv1_relu,
        conv1_scales=cfg.conv1_scales, conv1_round=cfg.conv1_round,
        groups=cfg.gp, sum_dt=cfg.sum_dt if cfg.with_sum else None,
        sum_scale=cfg.sum_scale)


def s2d_weights(cfg: ConvConfig, wei_oihw: np.ndarray) -> np.ndarray:
    """OIHW weights of the strided conv -> OIHW weights of the s2d conv."""
    w = np.asarray(wei_oihw)
    oc, ic, kh, kw = w.shape
    kh2, kw2 = s2d_taps(cfg)
    out = np.zeros((oc, cfg.sh * cfg.sw * ic, kh2, kw2), w.dtype)
    for ki in range(kh):
        qi, a = divmod(ki, cfg.sh)
        for kj in range(kw):
            qj, b = divmod(kj, cfg.sw)
            g = a * cfg.sw + b
            out[:, g * ic:(g + 1) * ic, qi, qj] = w[:, :, ki, kj]
    return out


def s2d_image_u8(cfg: ConvConfig, src_u8) -> torch.Tensor:
    """NHWC u8 (tensor on any device, or numpy) -> the s2d-grid NHWC u8
    image of the strided conv `cfg`, on the same device: the conv padding
    baked in as u8 zeros, rows and columns the stride never reads cropped,
    lane group g = (row % sh) * sw + (col % sw), channel g * ic + c."""
    cfg2 = s2d_cfg(cfg)
    x = torch.as_tensor(src_u8)
    n, ih, iw, ic = x.shape
    sh, sw = cfg.sh, cfg.sw
    hp, wp = cfg2.ih * sh, cfg2.iw * sw
    take_h = min(ih, hp - cfg.ph)
    take_w = min(iw, wp - cfg.pw)
    x = F.pad(x[:, :take_h, :take_w, :],
              (0, 0, cfg.pw, wp - cfg.pw - take_w,
               cfg.ph, hp - cfg.ph - take_h))
    x = x.reshape(n, cfg2.ih, sh, cfg2.iw, sw, ic).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, cfg2.ih, cfg2.iw, sh * sw * ic).contiguous()
