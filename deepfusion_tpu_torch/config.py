"""Frozen op configurations and their legality checks ("init_conf" layer).

The PyTorch counterpart of ``deepfusion_tpu/config.py``: the same fields and
the same checks and messages (reference: ``src/jit_call_conf.h:35-99``,
``src/jit_concat_kernel.cc:130-197``, ``src/op_conv.cc:263-365``). The TPU
lowering fields (lane padding, row tiles, ic chunks) are gone: each CUDA
kernel's wrapper picks its own tiling from the shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .types import dtype, round_mode
from .utils.device import default_device
from .utils.logger import CheckError, check, check_eq
from .utils.mathutil import conv_output_size, one_of, pool_output_size


def device_capabilities(device=None) -> dict:
    """Probe the device the port runs on (by default the current CUDA
    device; ``"cpu"`` for the plain versions), the analogue of the
    reference's ``mayiuse`` CPUID checks (``src/jit_generator.h:45-117``)
    and of the JAX package's probe. ``int8_native``: the device has int8
    tensor cores (compute capability 8.0 or later). The JAX probe's
    ``lanes`` is the TPU's vector width and has no counterpart here."""
    dev = default_device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "device_kind": "cpu", "num_devices": 1,
                "int8_native": False, "sm_count": 0, "capability": None}
    p = torch.cuda.get_device_properties(dev)
    return {"platform": "gpu", "device_kind": p.name,
            "num_devices": torch.cuda.device_count(),
            "int8_native": (p.major, p.minor) >= (8, 0),
            "sm_count": p.multi_processor_count,
            "capability": (p.major, p.minor)}


@dataclasses.dataclass(frozen=True)
class ConcatConfig:
    """Concat(+ReLU) config (reference: ``jit_concat_conf_t``,
    ``src/jit_call_conf.h:35-46``, ``src/jit_concat_kernel.cc:130-197``)."""

    n_inputs: int
    bs: int
    h: int
    w: int
    oc: int
    ics: Tuple[int, ...]
    dt: dtype
    with_relu: bool
    block: int

    @staticmethod
    def make(src_shapes, dt, with_relu: bool) -> "ConcatConfig":
        """Validate and build. src_shapes: list of NHWC tuples."""
        dt = dtype.from_any(dt)
        check(len(src_shapes) >= 1, "concat needs at least one input")
        if not one_of(dt.size, 1, 4):
            raise CheckError(f"concat supports u8/s8/s32/f32 only, got {dt}")
        n0, h0, w0 = src_shapes[0][0], src_shapes[0][1], src_shapes[0][2]
        ics = []
        for s in src_shapes:
            check_eq(len(s), 4, "concat inputs must be NHWC")
            check_eq((s[0], s[1], s[2]), (n0, h0, w0),
                     "concat inputs must share batch/spatial dims")
            ics.append(s[3])
        # reference channel-block legality (src/jit_concat_kernel.cc:155-196)
        blocks = (64, 32, 16) if dt.size == 1 else (16, 8, 4)
        block = 0
        for b in blocks:
            if all(ic % b == 0 for ic in ics):
                block = b
                break
        if block == 0:
            raise CheckError(
                f"concat channels {ics} not divisible by any of {blocks} "
                f"(reference legality, src/jit_concat_kernel.cc:155-196)")
        return ConcatConfig(
            n_inputs=len(src_shapes), bs=n0, h=h0, w=w0, oc=sum(ics),
            ics=tuple(ics), dt=dt, with_relu=with_relu, block=block)


def _as_scale_tuple(scales, n_oc: int, what: str) -> Tuple[float, ...]:
    arr = np.asarray(scales, dtype=np.float32).reshape(-1)
    if not one_of(arr.size, 1, n_oc):
        raise CheckError(
            f"{what} scales length must be 1 or {n_oc}, got {arr.size} "
            f"(reference: src/op_conv.cc:320,342-344)")
    return tuple(float(x) for x in arr)


@dataclasses.dataclass(frozen=True)
class ConvConfig:
    """Conv3x3(+ReLU)(+conv1x1+ReLU) config (reference:
    ``jit_conv_conf_t``, ``src/jit_call_conf.h:48-99``; validation from
    ``src/op_conv.cc:263-365`` and ``src/jit_conv_kernel.cc:512-673``)."""

    bs: int
    gp: int
    ic: int
    ih: int
    iw: int
    oc: int
    oh: int
    ow: int
    kh: int
    kw: int
    ph: int
    pw: int
    sh: int
    sw: int
    src_dt: dtype
    wei_dt: dtype
    bia_dt: Optional[dtype]
    dst_dt: dtype
    conv0_relu: bool
    conv0_scales: Tuple[float, ...]
    conv0_round: round_mode
    fuse_conv1x1: bool = False
    oc1x1: int = 0
    bia1x1_dt: Optional[dtype] = None
    conv1_relu: bool = False
    conv1_scales: Tuple[float, ...] = (1.0,)
    conv1_round: round_mode = round_mode.nearest
    # eltwise-sum post-op on the final stage: the operand is NHWC
    # (n, oh, ow, out_oc) of sum_dt, scaled by sum_scale (ops/requant.py)
    with_sum: bool = False
    sum_scale: float = 1.0
    sum_dt: Optional[dtype] = None

    @property
    def conv0_with_bias(self) -> bool:
        return self.bia_dt is not None

    @property
    def conv1_with_bias(self) -> bool:
        return self.bia1x1_dt is not None

    @property
    def conv0_multi_oc_scale(self) -> bool:
        return len(self.conv0_scales) > 1

    @property
    def conv1_multi_oc_scale(self) -> bool:
        return len(self.conv1_scales) > 1

    @property
    def out_oc(self) -> int:
        return self.oc1x1 if self.fuse_conv1x1 else self.oc

    @staticmethod
    def make(src_shape, wei_shape, bia_dt, stride, padding, dst_shape, dst_dt,
             *, src_dt=dtype.u8, wei_dt=dtype.s8,
             conv0_relu=False, conv0_scales=(1.0,),
             conv0_round=round_mode.nearest,
             wei1x1_shape=None, bia1x1_dt=None,
             conv1_relu=False, conv1_scales=(1.0,),
             conv1_round=round_mode.nearest,
             groups=1, sum_dt=None, sum_scale=1.0) -> "ConvConfig":
        """Validate and build; shapes are NHWC (src/dst) and OIHW (weights).
        ``src_dt`` is u8, or s8 for an unfused conv into u8 that
        ``ops/conv.py:unfold_cols`` does not unfold; ``sum_dt`` (u8, s8,
        s32 or f32) adds the eltwise-sum post-op."""
        src_dt = dtype.from_any(src_dt)
        wei_dt = dtype.from_any(wei_dt)
        dst_dt = dtype.from_any(dst_dt)
        bia_dt = dtype.from_any(bia_dt) if bia_dt is not None else None
        bia1x1_dt = dtype.from_any(bia1x1_dt) if bia1x1_dt is not None else None
        conv0_round = round_mode.from_any(conv0_round)
        conv1_round = round_mode.from_any(conv1_round)

        # input types (reference: src/op_conv.h:28-31, u8 only); an s8 src
        # is the port's, for a linear bottleneck's output (MobileNetV2)
        check(src_dt in (dtype.u8, dtype.s8),
              f"conv src must be u8 or s8, got {src_dt}")
        check_eq(wei_dt, dtype.s8, "conv weights must be s8")
        check_eq(groups, 1, "only groups==1 verified (src/op_conv.cc:348)")

        n, ih, iw, ic = src_shape
        oc, wic, kh, kw = wei_shape
        dn, oh, ow, doc = dst_shape
        sh, sw = stride
        ph, pw = padding
        check_eq(n, dn, "batch size must match (src/op_conv.cc:300-303)")
        check_eq(ic, wic, "input channels must match (src/op_conv.cc:305-308)")
        _check_geometry(ih, iw, oh, ow, kh, kw, sh, sw, ph, pw)

        fuse = wei1x1_shape is not None
        # the one conv the card runs over an s8 source
        # (conv_fused_s8src_kernel<DT_U8>): unfused, into u8, over 16 or
        # more channels or a kernel 1 wide (not unfolded)
        check(src_dt == dtype.u8 or (not fuse and dst_dt == dtype.u8
                                     and (ic >= 16 or kw == 1)),
              "an s8 conv source takes an unfused conv into u8 over 16 or "
              "more channels or a kernel 1 wide")
        if not fuse:
            check_eq(doc, oc, "output channels must match (src/op_conv.cc:312)")
            conv0_scales = _as_scale_tuple(conv0_scales, oc, "conv0")
            oc1x1 = 0
        else:
            oc1x1, wic1, k1h, k1w = wei1x1_shape
            check_eq(wic1, oc, "conv0 oc must equal conv1x1 ic "
                               "(src/op_conv.cc:326-329)")
            check_eq((k1h, k1w), (1, 1), "fused conv must be 1x1 "
                                         "(src/op_conv.cc:334-337)")
            check_eq(doc, oc1x1, "dst channels must equal oc1x1 "
                                 "(src/op_conv.cc:330-333)")
            conv0_scales = _as_scale_tuple(conv0_scales, oc, "conv0")
            conv1_scales = _as_scale_tuple(conv1_scales, oc1x1, "conv1")

        return ConvConfig(
            bs=n, gp=groups, ic=ic, ih=ih, iw=iw, oc=oc, oh=oh, ow=ow,
            kh=kh, kw=kw, ph=ph, pw=pw, sh=sh, sw=sw,
            src_dt=src_dt, wei_dt=wei_dt, bia_dt=bia_dt, dst_dt=dst_dt,
            conv0_relu=conv0_relu, conv0_scales=conv0_scales,
            conv0_round=conv0_round,
            fuse_conv1x1=fuse, oc1x1=oc1x1, bia1x1_dt=bia1x1_dt,
            conv1_relu=conv1_relu, conv1_scales=tuple(conv1_scales),
            conv1_round=conv1_round,
            with_sum=sum_dt is not None, sum_scale=float(sum_scale),
            sum_dt=dtype.from_any(sum_dt) if sum_dt is not None else None)


def _check_geometry(ih, iw, oh, ow, kh, kw, sh, sw, ph, pw):
    for name, i, k, s, p, o in (("h", ih, kh, sh, ph, oh),
                                ("w", iw, kw, sw, pw, ow)):
        expect = conv_output_size(i, k, s, p)
        if o != expect:
            raise CheckError(
                f"output {name} size mismatch: got {o}, expected {expect} "
                f"(src/op_conv.cc:291-298)")
    check(ph < kh and pw < kw, "padding must be < kernel")


def replace_geometry(cfg: ConvConfig, **kw) -> ConvConfig:
    """``dataclasses.replace`` for a new geometry (batch, image and output
    sizes, padding), with ``ConvConfig.make``'s geometry checks. The JAX
    package's version also re-picks its TPU row tile and ic chunks; the
    port has neither."""
    new = dataclasses.replace(cfg, **kw)
    _check_geometry(new.ih, new.iw, new.oh, new.ow, new.kh, new.kw, new.sh,
                    new.sw, new.ph, new.pw)
    return new


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Pooling config: max / avg-include-pad / avg-exclude-pad, any window,
    stride and padding (semantics: ``test/test_conv_relu_pooling.cc:313-391``).
    """

    kind: str  # 'max' | 'avg_inc' | 'avg_exc'
    kh: int
    kw: int
    ph: int
    pw: int
    sh: int
    sw: int
    ih: int
    iw: int
    oh: int
    ow: int
    # bottom/right padding including the ceil-mode overhang: the last window
    # may extend past ih + 2*ph (pool_output_size rounds up); overhang taps
    # are padding.
    pb: int = 0
    pr: int = 0
    round: round_mode = round_mode.nearest

    @staticmethod
    def make(kind, in_hw, kernel, stride, padding,
             round=round_mode.nearest, ceil_mode=True) -> "PoolConfig":
        """Validate and build. ``ceil_mode`` (the reference's rule) keeps a
        last window that starts inside the padded image; without it the
        output size is the conv's floor rule (torch's ``MaxPool2d``
        default, which ResNet's 3x3/s2/p1 stem pool assumes)."""
        check(kind in ("max", "avg_inc", "avg_exc"),
              f"unknown pooling kind {kind}")
        ih, iw = in_hw
        kh, kw = kernel
        sh, sw = stride
        ph, pw = padding
        size = pool_output_size if ceil_mode else conv_output_size
        oh = size(ih, kh, sh, ph)
        ow = size(iw, kw, sw, pw)
        pb = max(ph, (oh - 1) * sh + kh - ih - ph)
        pr = max(pw, (ow - 1) * sw + kw - iw - pw)
        return PoolConfig(kind=kind, kh=kh, kw=kw, ph=ph, pw=pw, sh=sh, sw=sw,
                          ih=ih, iw=iw, oh=oh, ow=ow, pb=pb, pr=pr,
                          round=round_mode.from_any(round))
