"""The conv eltwise-sum post-op of the PyTorch port vs the JAX package,
bitwise (CPU).

The port's ``conv(..., sum_src=, sum_scale=)`` (its plain PyTorch version)
against ``deepfusion_tpu.ops.conv.conv`` in Pallas interpret mode: every
sum operand dtype into every dst dtype, both round modes, fused and
unfused, sum_scale != 1, a strided conv with a sum, and operands that
saturate the result at both ends. Tolerance: bitwise, except one case.

For an f32 dst the sum is an f32 add after the scale multiply. XLA on the
CPU contracts that multiply-add into one FMA (the JAX package's requant
docstring: f32 sums are not bit-reproducible there), while the port, like
its kernel built with ``--fmad=false``, rounds the product first. So an
f32 dst with a sum is held bitwise to the specified order,
``relu?(f32(conv without sum) + f32(sum) * f32(sum_scale))``, and to the
JAX package within the one rounding the contraction skips:
``|port - jax| <= 2^-22 * (|conv| + |sum term|)`` elementwise.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops.conv import conv as jconv
from deepfusion_tpu_torch.config import ConvConfig
from deepfusion_tpu_torch.ops.conv import ConvOp
from deepfusion_tpu_torch.ops.conv import conv as tconv
from deepfusion_tpu_torch.utils.logger import CheckError
from deepfusion_tpu_torch.utils.mathutil import conv_output_size

torch.set_num_threads(2)

SUM_DTS = ("u8", "s8", "s32", "f32")
DSTS = ("u8", "s8", "s32", "f32")


def _sum_operand(rng, shape, dt, big=False):
    """Full-range operand of dtype dt; ``big`` pushes s32/f32 operands far
    past every dst's range at both ends."""
    if dt == "f32":
        a = rng.standard_normal(shape) * (1e9 if big else 150.0)
        a.reshape(-1)[:2] = [0.5, -2.5]    # ties of the round
        return a.astype(np.float32)
    info = np.iinfo({"u8": np.uint8, "s8": np.int8, "s32": np.int32}[dt])
    lo, hi = (info.min, info.max) if big or dt != "s32" else (-3000, 3000)
    a = rng.integers(lo, hi, shape, dtype=np.int64, endpoint=True)
    a.reshape(-1)[:2] = [info.min, info.max]
    return a.astype(info.dtype)


def _args(seed, dst, rnd, fused, sum_dt, *, stride=1, ic=16, hw=7,
          scale=None, big=False, sum_scale=0.75):
    rng = np.random.default_rng(seed)
    n, oc, oc1 = 2, 24, 16
    k, pad = 3, 1
    o = conv_output_size(hw, k, stride, pad)
    src = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    sc = scale if scale is not None else 1.0 / (k * k * ic * 40)
    kw = dict(dst_dtype=dst, conv0_relu=dst != "s8", conv0_round_mode=rnd,
              conv0_scales=(rng.uniform(0.5, 1.5, oc) * sc
                            ).astype(np.float32), sum_scale=sum_scale)
    if fused:
        kw.update(wei1x1=rng.integers(-128, 128, (oc1, oc, 1, 1)
                                      ).astype(np.int8),
                  bia1x1=rng.integers(-20000, 20000, (oc1,)
                                      ).astype(np.int32),
                  conv1_relu=dst == "u8", conv1_round_mode=rnd,
                  conv1_scales=(rng.uniform(0.5, 1.5, oc1)
                                * (sc if scale else 1.0 / (oc * 40))
                                ).astype(np.float32))
    kw["sum_src"] = _sum_operand(rng, (n, o, o, oc1 if fused else oc),
                                 sum_dt, big)
    return src, wei, bia, (stride, stride), (pad, pad), kw


def _check(args):
    src, wei, bia, stride, pad, kw = args
    want = np.asarray(jconv(src, wei, bia, stride, pad, **kw))
    got = tconv(src, wei, bia, stride, pad, **kw, device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if kw["dst_dtype"] != "f32":
        np.testing.assert_array_equal(got, want)
        return
    # f32: the specified order bitwise, JAX within one skipped rounding
    fused = "wei1x1" in kw
    relu = kw["conv1_relu" if fused else "conv0_relu"]
    nosum = {k: v for k, v in kw.items() if k not in ("sum_src", "sum_scale")}
    nosum["conv1_relu" if fused else "conv0_relu"] = False
    y0 = tconv(src, wei, bia, stride, pad, **nosum, device="cpu").numpy()
    st = kw["sum_src"].astype(np.float32) * np.float32(kw["sum_scale"])
    spec = y0 + st
    if relu:
        spec = np.maximum(spec, np.float32(0))
    np.testing.assert_array_equal(got, spec)
    bound = 2.0 ** -22 * (np.abs(y0) + np.abs(st))
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("rnd", ["nearest", "down"])
@pytest.mark.parametrize("dst", DSTS)
@pytest.mark.parametrize("sum_dt", SUM_DTS)
def test_sum_postop_matches_jax(sum_dt, dst, rnd, fused):
    seed = (SUM_DTS.index(sum_dt) * 16 + DSTS.index(dst) * 4
            + 2 * (rnd == "down") + fused)
    _check(_args(seed, dst, rnd, fused, sum_dt))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sum_dt", ["s8", "f32"])
def test_sum_postop_stride2_matches_jax(sum_dt, fused):
    _check(_args(70 + fused, "s8", "nearest", fused, sum_dt, stride=2,
                 ic=5, hw=9))


@pytest.mark.parametrize("sum_dt", ["s32", "f32"])
@pytest.mark.parametrize("dst", ["u8", "s8", "s32"])
def test_sum_postop_saturates_like_jax(dst, sum_dt):
    """Conv values and sum operands far past the dst range at both ends."""
    _check(_args(80 + DSTS.index(dst), dst, "nearest", False, sum_dt,
                 scale=1e6 if dst == "s32" else 0.05, big=True,
                 sum_scale=3.0))


def test_sum_scale_is_an_f32_multiply():
    """sum_scale 0.1 is not exact in f32: the operand is scaled by
    f32(0.1), as the JAX kernel's np.float32(sum_scale)."""
    _check(_args(90, "f32", "nearest", True, "s32", sum_scale=0.1))


def test_op_forward_with_sum_and_checks():
    src, wei, bia, stride, pad, kw = _args(91, "u8", "nearest", False, "u8")
    n, hw, _, ic = src.shape
    oc = wei.shape[0]
    cfg = ConvConfig.make((n, hw, hw, ic), wei.shape, bia.dtype, stride, pad,
                          (n, hw, hw, oc), "u8",
                          conv0_scales=kw["conv0_scales"], sum_dt="u8",
                          sum_scale=0.75)
    assert cfg.with_sum and cfg.sum_dt.name == "u8" and cfg.sum_scale == 0.75
    op = ConvOp(cfg, wei, bia, device="cpu")
    x, s = torch.from_numpy(src), torch.from_numpy(kw["sum_src"])
    np.testing.assert_array_equal(op(x, sum_src=s).numpy(),
                                  tconv(src, wei, bia, stride, pad, **kw,
                                        device="cpu"))
    with pytest.raises(ValueError, match="pass sum_src"):
        op(x)
    with pytest.raises(CheckError, match="sum operand dtype"):
        op(x, sum_src=s.to(torch.int8))
    with pytest.raises(CheckError, match="sum operand shape"):
        op(x, sum_src=s[:, 1:])
    plain = ConvOp(ConvConfig.make((n, hw, hw, ic), wei.shape, bia.dtype,
                                   stride, pad, (n, hw, hw, oc), "u8"),
                   wei, bia, device="cpu")
    with pytest.raises(CheckError, match="no sum post-op"):
        plain(x, sum_src=s)
