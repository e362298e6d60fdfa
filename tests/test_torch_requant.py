"""Requant epilogue of the PyTorch port vs the JAX package, bitwise.

The port's plain ``requant``/``requant_to_u8`` (the chain the CUDA kernels'
``csrc/requant.cuh`` repeats) against ``deepfusion_tpu.ops.requant`` over
s32 accumulators of the whole int32 range, .5 ties, both round modes and
all four dst types. Tolerance: bitwise; every step is one correctly rounded
IEEE operation in both packages. Then a numpy model of the kernels'
integer-domain final stage (``requant_int``) against the port's plain
``requant``, bitwise, with the argument for its exactness.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops import requant as JR
from deepfusion_tpu.types import dtype as jdtype
from deepfusion_tpu.types import round_mode as jround
from deepfusion_tpu_torch.ops import requant as TR
from deepfusion_tpu_torch.ops.conv import INT_SUM_SCALE_MAX
from deepfusion_tpu_torch.types import dtype, round_mode

torch.set_num_threads(2)

OC = 16


def _accs(rng):
    """Full-range s32 accumulators: random, the int32 edges, and odd values
    that a 0.5 scale turns into .5 ties."""
    edges = np.array([-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1, 2 ** 31 - 2, 0, 1,
                      -1, 255, 256, -128, -129, 511, 509, -3, 3, 5],
                     dtype=np.int64)
    rnd = rng.integers(-2 ** 31, 2 ** 31, (48, OC), dtype=np.int64)
    small = rng.integers(-600, 600, (48, OC), dtype=np.int64)
    ties = 2 * rng.integers(-300, 300, (16, OC), dtype=np.int64) + 1
    return np.concatenate([edges[None, :].repeat(4, 0), rnd, small,
                           ties]).astype(np.int32)


def _vectors(rng, with_bias, tie_scale):
    bias = (rng.integers(-400, 400, OC).astype(np.float32)
            if with_bias else None)
    if tie_scale:
        scale = np.full(OC, 0.5, np.float32)
    else:
        scale = rng.uniform(0.001, 2.0, OC).astype(np.float32)
    return bias, scale


@pytest.mark.parametrize("dst", ["u8", "s8", "s32", "f32"])
@pytest.mark.parametrize("mode", ["nearest", "down"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_bias,tie_scale", [(True, False),
                                                 (False, True)])
def test_requant_matches_jax(dst, mode, relu, with_bias, tie_scale):
    rng = np.random.default_rng(["u8 s8 s32 f32".split().index(dst),
                                 mode == "down", relu, with_bias])
    acc = _accs(rng)
    bias, scale = _vectors(rng, with_bias, tie_scale)
    want = np.asarray(JR.requant(
        jnp.asarray(acc), None if bias is None else jnp.asarray(bias),
        jnp.asarray(scale), relu, jround[mode], jdtype[dst]))
    got = TR.requant(torch.from_numpy(acc),
                     None if bias is None else torch.from_numpy(bias),
                     torch.from_numpy(scale), relu, round_mode[mode],
                     dtype[dst]).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nearest", "down"])
def test_requant_to_u8_matches_jax_centered(mode):
    rng = np.random.default_rng(3)
    acc = _accs(rng)
    bias, scale = _vectors(rng, True, False)
    centered = np.asarray(JR.requant_to_u8_centered(
        jnp.asarray(acc), jnp.asarray(bias), jnp.asarray(scale),
        jround[mode]))
    want = (centered.astype(np.int16) + 128).astype(np.uint8)
    got = TR.requant_to_u8(torch.from_numpy(acc), torch.from_numpy(bias),
                           torch.from_numpy(scale), round_mode[mode]).numpy()
    np.testing.assert_array_equal(got, want)


def test_s32_overflow_saturates_like_jax():
    """ROADMAP finding C1: f32 values >= 2^31 saturate to 2147483647 (a
    plain float->int32 convert would wrap to -2^31)."""
    acc = np.array([[2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30]], np.int32)
    scale = np.full(4, 4.0, np.float32)
    got = TR.requant(torch.from_numpy(acc), None, torch.from_numpy(scale),
                     False, round_mode.nearest, dtype.s32).numpy()
    want = np.asarray(JR.requant(jnp.asarray(acc), None, jnp.asarray(scale),
                                 False, jround.nearest, jdtype.s32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [[2147483647, -2147483648, 2147483647, -2147483648]])


def test_relu_f32_zero_sign_and_nan_like_jnp_maximum():
    x = np.array([-0.0, 0.0, -1.5, 2.5, np.nan], np.float32)
    got = TR.relu_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.maximum(jnp.asarray(x), 0.0))
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- the integer-domain final stage
# A numpy model of csrc/requant.cuh's requant_int, step for step in float32
# and int32 with bit views, held bitwise against the port's plain requant
# (with the sum post-op). Why it is exact:
#  * magic_round: for |x| <= 2^22, x + 1.5 * 2^23 lies in [2^23, 2^24], where
#    the f32 grid is the integers, so one correctly rounded add rounds x
#    (half to even, MAGIC being even; down with round-toward-minus-infinity)
#    and the bits less those of MAGIC are the integer.
#  * x is clamped to +-C (C = 2^21) and the sum term st = f32(v) * sum_scale
#    has |st| <= 255 * |sum_scale|. Where |x| <= C both paths add the same
#    two integers, exactly (below 2^24 in f32). Where x > C the f32 path's
#    round(x) + R is at least C - S, S = max |round(st)|, and so is C + R:
#    both saturate to the top of the dst while C - S > 255; x < -C the
#    same way to the bottom while -C + S < -128. S <= 2^21 - 255 holds for
#    |sum_scale| <= 8223.1; the kernel takes 8192 as its bound and keeps
#    the f32 path past it.
MAGIC = np.float32(12582912.0)
MAGIC_BITS = 0x4B400000
CLAMP = np.float32(2 ** 21)
SUM_SCALE_MAX = INT_SUM_SCALE_MAX   # the kernel's bound, 8192


def _magic_round(x, down):
    """round(x) as int32 by adding MAGIC in f32: to nearest even, or (down)
    toward minus infinity, which numpy's f32 add does not offer: the
    nearest sum, stepped one f32 down where it lies above the exact x +
    MAGIC (y - MAGIC is exact: both are integers in [2^23, 2^24])."""
    y = x + MAGIC
    if down:
        y = np.where(y - MAGIC > x, np.nextafter(y, np.float32(-np.inf)), y)
    return y.view(np.int32) - np.int32(MAGIC_BITS)


def _requant_int(acc, bias, scale, relu, down, dst, sum_bytes=None,
                 sum_s8=False, sum_scale=1.0):
    """requant_int<dst>: one int -> f32 conversion, the rest in f32 adds
    and multiplies, bit views and integer operations."""
    with np.errstate(over="ignore"):
        x = (acc.astype(np.float32) + bias) * scale
    r = _magic_round(np.minimum(np.maximum(x, -CLAMP), CLAMP), down)
    if sum_bytes is not None:
        b = sum_bytes.view(np.uint8).astype(np.int32)
        v = (b ^ 0x80) - 0x80 if sum_s8 else b
        vf = (v + np.int32(MAGIC_BITS)).view(np.float32) - MAGIC
        r = r + _magic_round(vf * np.float32(sum_scale), down)
    lo = 0 if relu or dst == "u8" else -128
    hi = 255 if dst == "u8" else 127
    return np.clip(r, lo, hi).astype(np.uint8 if dst == "u8" else np.int8)


def _takes_int_path(sum_dt, sum_scale):
    """csrc/conv.cu int_sum: with no sum always; with a 1-byte sum while
    |f32(sum_scale)| <= the bound."""
    return sum_dt is None or abs(np.float32(sum_scale)) <= SUM_SCALE_MAX


def _final_stage(acc, bias, scale, relu, down, dst, sum_bytes, sum_dt,
                 sum_scale):
    """The kernel's choice: requant_int, or the port's f32 requant."""
    if _takes_int_path(sum_dt, sum_scale):
        return _requant_int(acc, bias, scale, relu, down, dst, sum_bytes,
                            sum_dt == "s8", sum_scale)
    return _plain(acc, bias, scale, relu, down, dst, sum_bytes, sum_scale)


def _plain(acc, bias, scale, relu, down, dst, sum_bytes, sum_scale):
    st = None if sum_bytes is None else TR.sum_term(
        torch.from_numpy(sum_bytes), sum_scale)
    return TR.requant(torch.from_numpy(acc), torch.from_numpy(bias),
                      torch.from_numpy(scale), relu,
                      round_mode.down if down else round_mode.nearest,
                      dtype[dst], st).numpy()


def _edge_accs(rng):
    """_accs plus accumulators at 2^21 and 2^22 (scale 1: x there) and
    just under and over them, both signs, and the int32 extremes."""
    near = np.array([2 ** 21, 2 ** 22], np.int64)[:, None] + np.arange(-3, 4)
    near = np.concatenate([near, -near]).reshape(-1)
    near = np.concatenate([near, [2 ** 31 - 1, -2 ** 31 + 1, -2 ** 31]])
    near = np.resize(near, (-(-near.size // OC)) * OC).reshape(-1, OC)
    return np.concatenate([_accs(rng), near.astype(np.int32)])


SCALES = {
    # .5 ties: a 0.5 scale on odd accumulators
    "ties": lambda rng: np.full(OC, 0.5, np.float32),
    "random": lambda rng: rng.uniform(0.001, 2.0, OC).astype(np.float32),
    "negative": lambda rng: -rng.uniform(0.001, 2.0, OC).astype(np.float32),
    # x at 2^21 and 2^22 exactly, and a little either side
    "unit": lambda rng: np.ones(OC, np.float32),
    "edges": lambda rng: np.array(
        [1.0, 1.0000001, 0.9999999, 2.0, 0.5, -1.0, -1.0000001, -0.9999999,
         -2.0, -0.5, 1.5, 3.0, 1e-3, 1e3, 3e38, -3e38], np.float32),
}


@pytest.mark.parametrize("dst", ["u8", "s8"])
@pytest.mark.parametrize("sum_dt", [None, "u8", "s8"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("scales", list(SCALES))
def test_requant_int_matches_plain_requant(dst, sum_dt, relu, down, scales):
    """requant_int's model bitwise equal to the port's plain requant, with
    and without a 1-byte sum, over the whole int32 range, ties, x just
    under and over 2^21 and 2^22, and negative and overflowing scales; the
    sum at scales that make ties (0.5), negative, random and at the bound."""
    rng = np.random.default_rng([dst == "s8", 1 + (sum_dt == "s8")
                                 if sum_dt else 0, relu, down,
                                 list(SCALES).index(scales)])
    acc = _edge_accs(rng)
    bias = rng.integers(-400, 400, OC).astype(np.float32)
    bias[:4] = [0.0, 0.5, -0.5, 1e9]
    scale = SCALES[scales](rng)
    sums = [None] if sum_dt is None else [1.0, 0.5, -1.0, 0.37, 3.0,
                                          SUM_SCALE_MAX, -SUM_SCALE_MAX]
    for sum_scale in sums:
        sb = None if sum_dt is None else rng.integers(
            0, 256, acc.shape).astype(np.uint8).view(dtype[sum_dt].np)
        if sb is not None:
            sb.reshape(-1)[:4] = np.array([0, 255, 128, 127],
                                          np.uint8).view(sb.dtype)
        assert _takes_int_path(sum_dt, sum_scale)
        got = _requant_int(acc, bias, scale, relu, down, dst, sb,
                           sum_dt == "s8", sum_scale)
        want = _plain(acc, bias, scale, relu, down, dst, sb, sum_scale)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{sum_scale=}")


@pytest.mark.parametrize("sum_dt", ["u8", "s8"])
@pytest.mark.parametrize("sum_scale", [
    float(np.nextafter(np.float32(SUM_SCALE_MAX), np.float32(np.inf))),
    -float(np.nextafter(np.float32(SUM_SCALE_MAX), np.float32(np.inf))),
    9000.0, 1e30])
def test_sum_scale_past_the_bound_takes_the_f32_path(sum_dt, sum_scale):
    """Just past the bound the kernel keeps the f32 path (requant_sum),
    which is the plain requant at any sum_scale."""
    assert not _takes_int_path(sum_dt, sum_scale)
    acc = np.array([[2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30, 5, -5]],
                   np.int32)
    bias = np.zeros(6, np.float32)
    scale = np.ones(6, np.float32)
    byte = 255 if sum_dt == "u8" else 127
    for b in (byte, -128 if sum_dt == "s8" else 0):
        sb = np.full(acc.shape, b, np.int64).astype(dtype[sum_dt].np)
        for dst in ("u8", "s8"):
            got = _final_stage(acc, bias, scale, False, False, dst, sb,
                               sum_dt, sum_scale)
            np.testing.assert_array_equal(
                got, _plain(acc, bias, scale, False, False, dst, sb,
                            sum_scale))


@pytest.mark.parametrize("sum_dt, byte, sum_scale", [("u8", 255, -9000.0),
                                                     ("s8", -128, 20000.0)])
def test_requant_int_past_the_true_bound_would_be_wrong(sum_dt, byte,
                                                        sum_scale):
    """Why the kernel needs the bound: a sum term below -(2^21 - 255)
    (255 x -9000, -128 x 20000; both still round exactly) beside an x far
    above 2^21 clamped to 2^21 joins to a negative integer in the integer
    path, where the f32 path's join stays far above 255."""
    acc = np.array([[2 ** 31 - 1, 2 ** 30]], np.int32)
    bias, scale = np.zeros(2, np.float32), np.ones(2, np.float32)
    sb = np.full(acc.shape, byte, np.int64).astype(dtype[sum_dt].np)
    np.testing.assert_array_equal(
        _plain(acc, bias, scale, False, False, "u8", sb, sum_scale), 255)
    np.testing.assert_array_equal(
        _requant_int(acc, bias, scale, False, False, "u8", sb,
                     sum_dt == "s8", sum_scale), 0)


def test_requant_int_exact_up_to_the_true_bound():
    """The argument's bound, not the kernel's: at |sum_scale| = 8223 (S =
    2096865 <= 2^21 - 255) the integer path still saturates as the f32
    path does at x far past 2^21; the kernel's 8192 leaves room below."""
    acc = np.array([[2 ** 31 - 1, -2 ** 31, 2 ** 22 + 1, -2 ** 22 - 1,
                     2 ** 21 + 300, -2 ** 21 - 300]], np.int32)
    bias, scale = np.zeros(6, np.float32), np.ones(6, np.float32)
    for sum_dt, bytes_ in (("u8", (0, 255)), ("s8", (-128, 127))):
        for b in bytes_:
            sb = np.full(acc.shape, b, np.int64).astype(dtype[sum_dt].np)
            for s in (8223.0, -8223.0):
                for dst in ("u8", "s8"):
                    np.testing.assert_array_equal(
                        _requant_int(acc, bias, scale, False, False, dst, sb,
                                     sum_dt == "s8", s),
                        _plain(acc, bias, scale, False, False, dst, sb, s))
