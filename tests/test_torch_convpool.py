"""The fused conv+pool op (K9) of the PyTorch port vs the JAX package (CPU).

The port's ``ConvPoolOp`` (its plain PyTorch version) against the JAX
``ConvPoolOp`` in Pallas interpret mode, on the same seeded numpy inputs:
max and average pools, every dst the op takes, both conv and pool round
modes, with and without a sum operand, stride 1 and 2. Then
``pool2_fusable`` against the JAX rule on a grid of configs that fit the
JAX rule's VMEM budget, ``conv_relu_pool`` down both of its branches, and a
save/load round trip.

Tolerance: bitwise, except an f32 dst with a sum operand. There XLA on the
CPU contracts the JAX kernel's ``x * scale + sum`` into one FMA, while the
port rounds the product first (the kernel is built with ``--fmad=false``;
see tests/test_torch_sum_postop.py). Those cases are held bitwise to the
port's own conv with the sum (held to the specified order there), pooled
in f32 in the JAX order, and to the JAX package within a few roundings of
the operands: ``|port - jax| <= 2^-20 * max(|conv| + |sum term|)``.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu.config import ConvConfig as JConvConfig
from deepfusion_tpu.config import PoolConfig as JPoolConfig
from deepfusion_tpu.ops.convpool import ConvPoolOp as JConvPoolOp
from deepfusion_tpu.ops.convpool import pool2_fusable as jfusable
from deepfusion_tpu.ops.pool import conv_relu_pool as jconv_relu_pool
from deepfusion_tpu_torch.config import ConvConfig, PoolConfig
from deepfusion_tpu_torch.ops import layout
from deepfusion_tpu_torch.ops.conv import conv as tconv
from deepfusion_tpu_torch.ops.convpool import ConvPoolOp, pool2_fusable
from deepfusion_tpu_torch.ops.pool import conv_relu_pool
from deepfusion_tpu_torch.utils.logger import CheckError
from deepfusion_tpu_torch.utils.mathutil import conv_output_size

torch.set_num_threads(2)


def _make(seed, dst, kind, r0, rp, sum_dt, stride, *, ic=16, oc=24, hw=8,
          n=2, scale=None):
    """(port op, JAX op, src, sum operand or None) from one seeded draw."""
    rng = np.random.default_rng(seed)
    o = conv_output_size(hw, 3, stride, 1)
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    sc = scale if scale is not None else 1.0 / (9 * ic * 40)
    args = ((n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (stride, stride),
            (1, 1), (n, o, o, oc), dst)
    kw = dict(conv0_relu=dst != "s8", conv0_round=r0,
              conv0_scales=(rng.uniform(0.5, 1.5, oc) * sc
                            ).astype(np.float32),
              sum_dt=sum_dt, sum_scale=0.75)
    pargs = (kind, (o, o), (2, 2), (2, 2), (0, 0), rp)
    top = ConvPoolOp(ConvConfig.make(*args, **kw), PoolConfig.make(*pargs),
                     wei, bia, device="cpu")
    jop = JConvPoolOp(JConvConfig.make(*args, **kw), JPoolConfig.make(*pargs),
                      wei, bia)
    src = rng.integers(0, 256, (n, hw, hw, ic), dtype=np.uint8)
    sm = None
    if sum_dt == "f32":
        sm = (rng.standard_normal((n, o, o, oc)) * 150).astype(np.float32)
    elif sum_dt is not None:
        info = np.iinfo({"u8": np.uint8, "s8": np.int8,
                         "s32": np.int32}[sum_dt])
        lo, hi = (-5000, 5000) if sum_dt == "s32" else (info.min, info.max)
        sm = rng.integers(lo, hi, (n, o, o, oc), dtype=np.int64,
                          endpoint=True).astype(info.dtype)
    return top, jop, src, sm


def _run(top, jop, src, sm):
    got = top(torch.from_numpy(src),
              None if sm is None else torch.from_numpy(sm)).numpy()
    want = np.asarray(jop(src, sum_src=sm))
    assert got.dtype == want.dtype and got.shape == want.shape
    return got, want


def _f32_sum_spec(top, src, sm):
    """The specified order for an f32 dst with a sum: the port's conv with
    the sum, pooled in f32 in the JAX order; and the bound of the JAX
    package's distance from it (module docstring)."""
    cfg, pc = top.cfg, top.pc
    wei = layout.unpack_weights(top.w0, cfg.oc, cfg.ic, cfg.kh, cfg.kw)
    kw = dict(dst_dtype="f32", conv0_scales=cfg.conv0_scales,
              conv0_round_mode=cfg.conv0_round)
    args = (src, wei.numpy(), top.bias0[:cfg.oc].numpy(), (cfg.sh, cfg.sw),
            (cfg.ph, cfg.pw))
    y = tconv(*args, conv0_relu=cfg.conv0_relu, sum_src=sm,
              sum_scale=cfg.sum_scale, **kw, device="cpu").numpy()
    y0 = tconv(*args, conv0_relu=False, **kw, device="cpu").numpy()
    st = sm * np.float32(cfg.sum_scale)
    n, h, w, c = y.shape
    x = y.reshape(n, h // 2, 2, w // 2, 2, c)
    x00, x01, x10, x11 = (x[:, :, 0, :, 0], x[:, :, 0, :, 1],
                          x[:, :, 1, :, 0], x[:, :, 1, :, 1])
    if pc.kind == "max":
        spec = np.maximum(np.maximum(x00, x01), np.maximum(x10, x11))
    else:
        spec = (((x00 + x01) + x10) + x11) * np.float32(0.25)
    return spec, 2.0 ** -20 * (np.abs(y0) + np.abs(st)).max()


CASES = [(kind, dst) for kind in ("max", "avg_exc")
         for dst in ("u8", "s8", "s32", "f32")
         if not (kind == "avg_exc" and dst == "s32")]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_sum", [False, True])
@pytest.mark.parametrize("rounds", [("nearest", "down"), ("down", "nearest")])
@pytest.mark.parametrize("kind,dst", CASES)
def test_convpool_matches_jax(kind, dst, rounds, with_sum, stride):
    sum_dt = ({"u8": "u8", "s8": "s8", "s32": "s32", "f32": "f32"}[dst]
              if with_sum else None)
    seed = CASES.index((kind, dst)) * 8 + 4 * (rounds[0] == "down") \
        + 2 * with_sum + stride
    top, jop, src, sm = _make(seed, dst, kind, *rounds, sum_dt, stride,
                              hw=8 * stride)
    got, want = _run(top, jop, src, sm)
    if not (with_sum and dst == "f32"):
        np.testing.assert_array_equal(got, want)
        return
    spec, bound = _f32_sum_spec(top, src, sm)
    np.testing.assert_array_equal(got, spec)
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("dst,kind", [("u8", "max"), ("s8", "avg_exc"),
                                      ("s32", "max")])
def test_convpool_saturating_conv_matches_jax(dst, kind):
    """Conv values far past the dst range (s32 reaches the f32 clip bound
    2^31, which must saturate to 2^31 - 1, not wrap)."""
    top, jop, src, sm = _make(50, dst, kind, "nearest", "nearest", None, 1,
                              scale=1e6 if dst == "s32" else 0.05)
    got, want = _run(top, jop, src, sm)
    np.testing.assert_array_equal(got, want)
    info = np.iinfo(got.dtype)
    assert got.max() == info.max
    if dst == "s8":   # no ReLU: the low end saturates too
        assert got.min() == info.min


def test_convpool_odd_ic_u8_sum_matches_jax():
    top, jop, src, sm = _make(51, "u8", "max", "down", "nearest", "u8", 2,
                              ic=3, oc=16, hw=12)
    np.testing.assert_array_equal(*_run(top, jop, src, sm))


def _fusable_grid():
    for kind in ("max", "avg_inc", "avg_exc"):
        for dst in ("u8", "s8", "s32", "f32"):
            for fuse in (False, True):
                for hw in (8, 9):
                    for stride in (1, 2):
                        for pool in (((2, 2), (2, 2), (0, 0)),
                                     ((3, 3), (2, 2), (1, 1)),
                                     ((2, 2), (1, 1), (0, 0))):
                            yield kind, dst, fuse, hw, stride, pool


def test_pool2_fusable_matches_jax():
    """The semantic part of the JAX rule, on configs small enough that its
    VMEM clause (a TPU row tile) always holds."""
    seen = set()
    for kind, dst, fuse, hw, stride, (k, s, p) in _fusable_grid():
        o = conv_output_size(hw, 3, stride, 1)
        args = ((1, hw, hw, 32), (32, 32, 3, 3), None, (stride, stride),
                (1, 1), (1, o, o, 16 if fuse else 32), dst)
        kw = dict(wei1x1_shape=(16, 32, 1, 1)) if fuse else {}
        got = pool2_fusable(ConvConfig.make(*args, **kw),
                            PoolConfig.make(kind, (o, o), k, s, p))
        want = jfusable(JConvConfig.make(*args, **kw),
                        JPoolConfig.make(kind, (o, o), k, s, p))
        assert got == want, (kind, dst, fuse, hw, stride, k, s, p)
        seen.add(got)
    assert seen == {True, False}


@pytest.mark.parametrize("geometry", ["fused 2x2/s2", "composed 3x3/s2/p1"])
def test_conv_relu_pool_matches_jax(geometry):
    rng = np.random.default_rng(60)
    src = rng.integers(0, 256, (2, 9, 9, 16), dtype=np.uint8)
    wei = rng.integers(-128, 128, (32, 16, 3, 3)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (32,)).astype(np.int32)
    pk, ps, pp = ((2, 2), (2, 2), (0, 0)) if geometry.startswith("fused") \
        else ((3, 3), (2, 2), (1, 1))
    hw = 8 if geometry.startswith("fused") else 9
    src = src[:, :hw, :hw]
    kw = dict(dst_dtype="s8", conv_scales=(1.0 / (9 * 16 * 40),),
              conv_relu=False, conv_round_mode="down", pool_kind="avg_exc",
              pool_kernel=pk, pool_stride=ps, pool_padding=pp,
              pool_round_mode="nearest")
    got = conv_relu_pool(src, wei, bia, (1, 1), (1, 1), **kw, device="cpu")
    want = np.asarray(jconv_relu_pool(src, wei, bia, (1, 1), (1, 1), **kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_save_load_roundtrip(tmp_path):
    top, _, src, sm = _make(70, "u8", "avg_exc", "down", "down", "s32", 2,
                            hw=16)
    path = str(tmp_path / "cp.npz")
    top.save(path)
    op2 = ConvPoolOp.load(path, device="cpu")
    assert (op2.cfg, op2.pc) == (top.cfg, top.pc)
    x, s = torch.from_numpy(src), torch.from_numpy(sm)
    assert torch.equal(top(x, s), op2(x, s))


def test_rejects_unfusable_and_bad_operands():
    top, _, src, sm = _make(71, "u8", "max", "nearest", "nearest", "u8", 1)
    cfg = ConvConfig.make((1, 8, 8, 16), (8, 16, 3, 3), None, (1, 1), (1, 1),
                          (1, 8, 8, 8), "s32")
    with pytest.raises(CheckError, match="fusable"):
        ConvPoolOp(cfg, PoolConfig.make("avg_exc", (8, 8), (2, 2), (2, 2),
                                        (0, 0)), np.zeros((8, 16, 3, 3),
                                                          np.int8),
                   device="cpu")
    with pytest.raises(ValueError, match="pass sum_src"):
        top(torch.from_numpy(src))
    with pytest.raises(CheckError, match="sum operand shape"):
        top(torch.from_numpy(src), torch.from_numpy(sm[:, :, 1:]))
