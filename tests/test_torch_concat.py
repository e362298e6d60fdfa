"""Concat(+ReLU) of the PyTorch port vs the JAX package, bitwise.

1-3 inputs, 17 and 40, and the reference's three shape sets, in all four
dtypes, with and without the true ReLU, on full-range data
(saturation edges included), against
``deepfusion_tpu.ops.concat`` in Pallas interpret mode; the config that
``concat()`` keeps per shapes, dtype and ReLU, and its checks, which raise
the JAX package's errors on every call.
"""
import importlib

import numpy as np
import pytest
import torch

from deepfusion_tpu.ops.concat import concat as jconcat
from deepfusion_tpu_torch.config import ConcatConfig
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


BAD_CALLS = {
    "dtype mismatch": lambda: [np.zeros((1, 2, 2, 16), np.uint8),
                               np.zeros((1, 2, 2, 16), np.int8)],
    "channels not divisible": lambda: [np.zeros((1, 2, 2, 8), np.uint8)],
    "batch/spatial mismatch": lambda: [np.zeros((1, 2, 2, 16), np.uint8),
                                       np.zeros((1, 2, 3, 16), np.uint8)],
    "not NHWC": lambda: [np.zeros((2, 2, 16), np.uint8)],
}


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_cached_config_raises_like_jax_on_every_call(case):
    """concat() keeps its configs, but a failing check is not kept: the
    same bad call raises the JAX package's error each time, and a good
    call of the same shapes between them changes nothing."""
    xs = BAD_CALLS[case]()
    want = _raised(lambda: jconcat(xs, post_relu=True))
    for _ in range(3):
        got = _raised(lambda: tconcat([torch.from_numpy(x) for x in xs],
                                      post_relu=True, device="cpu"))
        assert got == want
        if case == "dtype mismatch":
            tconcat([torch.from_numpy(xs[0])] * 2, post_relu=True,
                    device="cpu")


def test_concat_builds_a_config_once_per_shapes(monkeypatch):
    """Seen shapes, dtype and ReLU reuse their config; each new key
    builds one."""
    # the module: deepfusion_tpu_torch.ops's "concat" is the function
    mod = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    made = []
    real = ConcatConfig.make

    def make(*a, **k):
        made.append(a)
        return real(*a, **k)
    monkeypatch.setattr(ConcatConfig, "make", staticmethod(make))
    mod._config.cache_clear()
    a = torch.zeros((1, 2, 2, 16), dtype=torch.uint8)
    b = torch.zeros((1, 2, 2, 32), dtype=torch.uint8)
    for _ in range(5):
        tconcat([a, b], post_relu=True, device="cpu")
    assert len(made) == 1
    tconcat([a, b], post_relu=False, device="cpu")
    tconcat([a.to(torch.int8), b.to(torch.int8)], post_relu=True,
            device="cpu")
    tconcat([b, a], post_relu=True, device="cpu")
    assert len(made) == 4
    for _ in range(5):
        tconcat([b, a], post_relu=True, device="cpu")
    assert len(made) == 4
    mod._config.cache_clear()


@pytest.mark.parametrize("relu", [True, False])
def test_same_shapes_as_u8_then_s8_match_jax(relu):
    """The config is keyed by dtype too: the same shapes as u8 and then
    as s8 (whose ReLU is not the identity) each equal the JAX result."""
    rng = np.random.default_rng([7, relu])
    shapes = [(2, 3, 5, 16), (2, 3, 5, 48)]
    for dt in ("u8", "s8", "u8", "s8"):
        xs = [full_range(rng, s, dt) for s in shapes]
        want = np.asarray(jconcat(xs, post_relu=relu))
        got = tconcat([torch.from_numpy(x) for x in xs], post_relu=relu,
                      device="cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n_in", [17, 40])
@pytest.mark.parametrize("relu", [True, False])
def test_concat_many_inputs_match_jax(dt, n_in, relu):
    """Many narrow inputs: the JAX package sets no count, and the port
    computes every count (on the card in one launch)."""
    rng = np.random.default_rng([DTYPES.index(dt), n_in, relu, 17])
    unit = 4 if dt in ("s32", "f32") else 16
    xs = [full_range(rng, (1, 2, 3, unit * (1 + i % 3)), dt)
          for i in range(n_in)]
    want = np.asarray(jconcat(xs, post_relu=relu))
    got = tconcat([torch.from_numpy(x) for x in xs], post_relu=relu,
                  device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# the reference's three default shape sets (bench.py:450-451, from its
# benchmark/bench_concat.cc:226-242), at batch 1
REFERENCE_SETS = {244: (128, 256, 128, 256), 64: (64, 96, 64, 96),
                  9: (16, 64, 16, 64)}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hw", sorted(REFERENCE_SETS))
def test_concat_reference_sets_match_jax(hw, dt):
    """Four inputs with ReLU at the reference benchmark's shapes (its s8
    sets, here in every dtype the channel rule allows)."""
    rng = np.random.default_rng([hw, DTYPES.index(dt)])
    xs = [full_range(rng, (1, hw, hw, c), dt) for c in REFERENCE_SETS[hw]]
    want = np.asarray(jconcat(xs, post_relu=True))
    got = tconcat([torch.from_numpy(x) for x in xs], post_relu=True,
                  device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
