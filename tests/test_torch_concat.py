"""Concat(+ReLU) of the PyTorch port vs the JAX package, bitwise.

1-3 inputs in all four dtypes, with and without the true ReLU, on
full-range data (saturation edges included), against
``deepfusion_tpu.ops.concat`` in Pallas interpret mode.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu.ops.concat import concat as jconcat
from deepfusion_tpu_torch.ops.concat import concat as tconcat
from deepfusion_tpu_torch.utils.logger import CheckError

from test_torch_pool import DTYPES, full_range

torch.set_num_threads(2)

CHANNELS = {1: {1: [32], 4: [8]},
            2: {1: [16, 48], 4: [4, 12]},
            3: {1: [32, 16, 64], 4: [8, 4, 16]}}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n_in", [1, 2, 3])
@pytest.mark.parametrize("relu", [True, False])
def test_concat_matches_jax(dt, n_in, relu):
    rng = np.random.default_rng([DTYPES.index(dt), n_in, relu])
    size = 4 if dt in ("s32", "f32") else 1
    xs = [full_range(rng, (2, 3, 5, ic), dt) for ic in CHANNELS[n_in][size]]
    want = np.asarray(jconcat(xs, post_relu=relu))
    got = tconcat([torch.from_numpy(x) for x in xs], post_relu=relu,
                  device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_concat_rejects_like_jax():
    a = np.zeros((1, 2, 2, 16), np.uint8)
    with pytest.raises(ValueError, match="share dtype"):
        tconcat([torch.from_numpy(a), torch.zeros((1, 2, 2, 16),
                                                  dtype=torch.int8)],
                device="cpu")
    with pytest.raises(CheckError, match="not divisible"):
        tconcat([torch.zeros((1, 2, 2, 8), dtype=torch.uint8)], device="cpu")
