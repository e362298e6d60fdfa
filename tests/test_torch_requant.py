"""Requant epilogue of the PyTorch port vs the JAX package, bitwise.

The port's plain ``requant``/``requant_to_u8`` (the chain the CUDA kernels'
``csrc/requant.cuh`` repeats) against ``deepfusion_tpu.ops.requant`` over
s32 accumulators of the whole int32 range, .5 ties, both round modes and
all four dst types. Tolerance: bitwise; every step is one correctly rounded
IEEE operation in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops import requant as JR
from deepfusion_tpu.types import dtype as jdtype
from deepfusion_tpu.types import round_mode as jround
from deepfusion_tpu_torch.ops import requant as TR
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
