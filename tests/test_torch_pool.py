"""Pooling and eltwise-sum+ReLU of the PyTorch port vs the JAX package.

``pool`` (max, avg_inc, avg_exc; padded strided windows and global windows)
and ``eltwise_sum_relu``, each in all four dtypes with full-range data that
includes the saturation edges, against ``deepfusion_tpu.ops.pool`` in Pallas
interpret mode. Tolerance: bitwise.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops.pool import eltwise_sum_relu as jsum
from deepfusion_tpu.ops.pool import pool as jpool
from deepfusion_tpu_torch.ops.pool import eltwise_sum_relu as tsum
from deepfusion_tpu_torch.ops.pool import pool as tpool

torch.set_num_threads(2)

DTYPES = ["u8", "s8", "s32", "f32"]
_NP = {"u8": np.uint8, "s8": np.int8, "s32": np.int32, "f32": np.float32}


def full_range(rng, shape, dt):
    """Random values over the dtype's whole range, edges included (f32:
    finite normals, no NaN)."""
    if dt == "f32":
        return (rng.standard_normal(shape) * 1000).astype(np.float32)
    info = np.iinfo(_NP[dt])
    a = rng.integers(info.min, info.max, shape, dtype=np.int64,
                     endpoint=True).astype(_NP[dt])
    a.reshape(-1)[:4] = [info.min, info.max, info.min + 1, info.max - 1]
    return a


# (kind, shape, kernel, stride, padding, round)
WINDOWS = {
    "max-3x3-s2-p1": ("max", (2, 9, 11, 8), (3, 3), (2, 2), (1, 1), "nearest"),
    "max-2x2-s2": ("max", (1, 8, 8, 16), (2, 2), (2, 2), (0, 0), "nearest"),
    "avginc-3x3-s2-p1": ("avg_inc", (2, 9, 11, 8), (3, 3), (2, 2), (1, 1),
                         "nearest"),
    "avginc-2x2-s1-down": ("avg_inc", (1, 6, 7, 8), (2, 2), (1, 1), (0, 0),
                           "down"),
    "avgexc-3x3-s2-p1": ("avg_exc", (2, 9, 11, 8), (3, 3), (2, 2), (1, 1),
                         "nearest"),
    "avgexc-global": ("avg_exc", (2, 7, 7, 16), (7, 7), (7, 7), (0, 0),
                      "nearest"),
    "avgexc-global-down": ("avg_exc", (1, 10, 10, 8), (10, 10), (10, 10),
                           (0, 0), "down"),
    "max-global": ("max", (1, 9, 9, 8), (9, 9), (9, 9), (0, 0), "nearest"),
}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_pool_matches_jax(name, dt):
    kind, shape, k, s, p, rnd = WINDOWS[name]
    rng = np.random.default_rng([sorted(WINDOWS).index(name),
                                 DTYPES.index(dt)])
    x = full_range(rng, shape, dt)
    want = np.asarray(jpool(x, kind, k, s, p, rnd))
    got = tpool(torch.from_numpy(x), kind, k, s, p, rnd, device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("relu", [True, False])
def test_eltwise_sum_relu_matches_jax(dt, relu):
    rng = np.random.default_rng([DTYPES.index(dt), relu])
    shape = (2, 5, 3, 16)
    a, b = full_range(rng, shape, dt), full_range(rng, shape, dt)
    if dt != "f32":   # force both saturation ends
        info = np.iinfo(_NP[dt])
        a.reshape(-1)[:2] = [info.max, info.min]
        b.reshape(-1)[:2] = [info.max, info.min]
    want = np.asarray(jsum(a, b, relu))
    got = tsum(torch.from_numpy(a), torch.from_numpy(b), relu,
               device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
