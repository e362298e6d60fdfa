"""FusionNet and BatchServer of the PyTorch port vs the JAX package.

The dense forward on the CPU (each op's plain PyTorch version) against the
JAX ``FusionNet`` in Pallas interpret mode, bitwise on the f32 logits: every
step of the integer pipeline is exact and every f32 step is one correctly
rounded IEEE operation in both packages.
"""
import os

import numpy as np
import pytest
import torch

from deepfusion_tpu.models import FusionNet as JFusionNet
from deepfusion_tpu.models import FusionNetConfig as JConfig
from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
from deepfusion_tpu_torch.models.fusionnet import LAYERS
from deepfusion_tpu_torch.serving import BatchServer

torch.set_num_threads(2)

SMALL = dict(batch=1, hw=8, in_ch=16, width=32, num_classes=16)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "fusionnet_full_logits.npz")


@pytest.fixture(scope="module")
def jax_net():
    return JFusionNet(JConfig(**SMALL))


@pytest.fixture(scope="module")
def net():
    return FusionNet(FusionNetConfig(**SMALL))


def _jax_params_as_numpy(jnet) -> dict:
    out = {}
    for name in LAYERS:
        p = jnet.params[name]
        cfg = p.cfg
        d = dict(wei=np.asarray(p.wei), bia=np.asarray(p.bia),
                 conv0_scales=np.asarray(cfg.conv0_scales, np.float32),
                 conv0_relu=cfg.conv0_relu, dst_dt=cfg.dst_dt.name)
        if cfg.fuse_conv1x1:
            d.update(wei1=np.asarray(p.wei1), bia1=np.asarray(p.bia1),
                     conv1_scales=np.asarray(cfg.conv1_scales, np.float32),
                     conv1_relu=cfg.conv1_relu)
        out[name] = d
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed, jax_net, net):
    x = net.example_input(np.random.default_rng(seed))
    want = np.asarray(jax_net(x))
    got = net(x).numpy()
    assert got.shape == (1, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_same_seed_same_weights(jax_net, net):
    for name in LAYERS:
        p = jax_net.params[name]
        np.testing.assert_array_equal(net.params[name]["wei"], p.wei)
        assert getattr(net, name).cfg.conv0_scales == p.cfg.conv0_scales


def test_from_numpy_params_matches_jax(jax_net):
    x = jax_net.example_input(np.random.default_rng(5))
    net2 = FusionNet.from_numpy_params(FusionNetConfig(**SMALL),
                                       _jax_params_as_numpy(jax_net))
    np.testing.assert_array_equal(net2(x).numpy(), np.asarray(jax_net(x)))


def test_full_width_matches_jax_golden_logits():
    """FusionNetConfig() at its published width (batch 8, 56x56, 32 -> 128
    channels) against logits the JAX package's dense forward wrote
    (tests/data/make_fusionnet_full_logits.py)."""
    golden = np.load(GOLDEN)
    cfg = FusionNetConfig()
    assert int(golden["model_seed"]) == cfg.seed
    net = FusionNet(cfg)
    x = net.example_input(np.random.default_rng(int(golden["input_seed"])))
    with torch.inference_mode():
        got = net(x).numpy()
    np.testing.assert_array_equal(got, golden["logits"])


def test_batch_server_matches_direct_calls(net):
    xs = [net.example_input(np.random.default_rng(10 + i))[0]
          for i in range(5)]
    with torch.inference_mode():
        direct = [net(x[None]).numpy()[0] for x in xs]
    srv = BatchServer(net, batch=2, input_shape=net.input_shape[1:],
                      max_delay_ms=5.0)
    with srv:
        outs = [f.result(timeout=60) for f in srv.submit_many(xs)]
    for o, d in zip(outs, direct):
        np.testing.assert_array_equal(o, d)
    assert srv.stats["requests"] == 5
    assert srv.stats["flushes"] >= 3
    assert srv.stats["padded_rows"] >= 1


def test_batch_server_worker_runs_in_inference_mode():
    seen = []

    def model(x):
        seen.append(torch.is_inference_mode_enabled())
        return x.to(torch.int32) * 2

    with BatchServer(model, batch=2, input_shape=(3,)) as srv:
        out = srv.submit(np.full((3,), 7, np.uint8)).result(timeout=30)
    np.testing.assert_array_equal(out, np.full((3,), 14, np.int32))
    assert seen and all(seen)
