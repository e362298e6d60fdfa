"""ResFusionNet and BatchServer of the PyTorch port vs the JAX package.

The dense and packed forwards on the CPU (each op's plain PyTorch version)
against the JAX ``ResFusionNet`` in Pallas interpret mode, bitwise on the
f32 logits: the strided stem, the residual sum post-op, the fused
conv+pool downsample and the head are exact integer pipelines up to one
correctly rounded f32 epilogue in both packages.
"""
import os

import numpy as np
import pytest
import torch

from deepfusion_tpu.models import ResFusionNet as JResFusionNet
from deepfusion_tpu.models import ResFusionNetConfig as JConfig
from deepfusion_tpu_torch.models import (PackedFusionNet, ResFusionNet,
                                         ResFusionNetConfig)
from deepfusion_tpu_torch.models.resfusion import LAYERS
from deepfusion_tpu_torch.serving import BatchServer

torch.set_num_threads(2)

SMALL = dict(batch=1, hw=16, in_ch=16, width=32, num_classes=16)
# the packed geometry of tests/test_models.py:93-103
PACKED = dict(batch=2, hw=32, in_ch=16, width=64, num_classes=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "resfusion_full_logits.npz")


@pytest.fixture(scope="module")
def jax_net():
    return JResFusionNet(JConfig(**SMALL))


@pytest.fixture(scope="module")
def net():
    return ResFusionNet(ResFusionNetConfig(**SMALL), device="cpu")


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
        if cfg.with_sum:
            d.update(sum_dt=cfg.sum_dt.name, sum_scale=cfg.sum_scale)
        out[name] = d
    return out


def test_random_params_equal_jax_params(jax_net, net):
    ref = _jax_params_as_numpy(jax_net)
    for name in LAYERS:
        got, want = net.params[name], ref[name]
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v,
                                          err_msg=f"{name}.{k}")


def test_layer_configs_match_jax(jax_net, net):
    """Stride, padding, the sum post-op and the pool of every layer."""
    for name in LAYERS:
        jcfg = jax_net.params[name].cfg
        cfg = getattr(net, name).cfg
        for f in ("ih", "iw", "ic", "oh", "ow", "oc", "kh", "sh", "ph",
                  "fuse_conv1x1", "with_sum", "sum_scale", "conv0_relu"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)

    def named(pc):
        return {k: getattr(v, "name", v) for k, v in vars(pc).items()}
    assert named(net.down.pc) == named(jax_net.down.pc)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed, jax_net, net):
    x = net.example_input(np.random.default_rng(seed))
    want = np.asarray(jax_net(x))
    got = net(x).numpy()
    assert got.shape == (1, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_from_numpy_params_matches_jax(jax_net):
    x = jax_net.example_input(np.random.default_rng(5))
    net2 = ResFusionNet.from_numpy_params(ResFusionNetConfig(**SMALL),
                                          _jax_params_as_numpy(jax_net),
                                          device="cpu")
    np.testing.assert_array_equal(net2(x).numpy(), np.asarray(jax_net(x)))


@pytest.fixture(scope="module")
def packed_nets():
    return (JResFusionNet(JConfig(**PACKED)),
            ResFusionNet(ResFusionNetConfig(**PACKED), device="cpu"))


@pytest.mark.parametrize("seed", [0, 3])
def test_packed_forward_matches_jax_packed_call(seed, packed_nets):
    jnet, tnet = packed_nets
    x = tnet.example_input(np.random.default_rng(seed))
    want = np.asarray(jnet.jit_packed()(x))
    with torch.inference_mode():
        got = tnet.packed_call(x).numpy()
        dense = tnet(x).numpy()
    assert got.shape == (2, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)


def test_packed_specs_match_jax_build_packed(packed_nets):
    jnet, tnet = packed_nets
    jops, tops = jnet.build_packed(), tnet.build_packed()
    assert list(jops) == list(tops)
    for name, jop in jops.items():
        top = tops[name]
        assert [vars(s) for s in top.sins] == [vars(s) for s in jop.sins]
        assert vars(top.sout) == vars(jop.sout)
        assert (top.ssum is None) == (jop.ssum is None)
        if top.ssum is not None:
            assert vars(top.ssum) == vars(jop.ssum)
        assert (top.cfg_orig is None) == (jop.cfg_orig is None)
    # the stem runs on the s2d grid: 2x2 taps over 4x the channels
    stem = tops["stem"]
    assert (stem.cfg.kh, stem.cfg.sh, stem.cfg.ic) == (2, 1, 4 * 16)
    assert stem.cfg_orig.sh == 2


def _golden_input(net):
    golden = np.load(GOLDEN)
    assert int(golden["model_seed"]) == net.cfg.seed
    return golden, net.example_input(
        np.random.default_rng(int(golden["input_seed"])))


def test_full_width_matches_jax_golden_logits():
    """ResFusionNetConfig() at its published width (batch 8, 64x64x32 in,
    width 128) against logits the JAX package's dense forward wrote
    (tests/data/make_resfusion_full_logits.py), on both forwards."""
    net = ResFusionNet(ResFusionNetConfig(), device="cpu")
    golden, x = _golden_input(net)
    with torch.inference_mode():
        dense = net(x).numpy()
        packed = net.packed_module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(dense, golden["logits"])
    np.testing.assert_array_equal(packed, golden["logits"])


def test_batch_server_packed_module_matches_direct_calls(net):
    mod = net.packed_module()
    assert isinstance(mod, PackedFusionNet)
    assert mod.device == net.device and mod.input_shape == net.input_shape
    xs = [net.example_input(np.random.default_rng(20 + i))[0]
          for i in range(5)]
    with torch.inference_mode():
        direct = [net(x[None]).numpy()[0] for x in xs]
    srv = BatchServer(mod, batch=2, input_shape=mod.input_shape[1:],
                      max_delay_ms=5.0)
    with srv:
        outs = [f.result(timeout=60) for f in srv.submit_many(xs)]
    for o, d in zip(outs, direct):
        np.testing.assert_array_equal(o, d)
    assert srv.stats["requests"] == 5


def test_batch_server_stages_packed_batches_on_the_module_device(
        net, monkeypatch):
    """The served module carries its model's device, and the worker moves
    each batch there before the packed forward sees it (ROADMAP C5)."""
    mod = net.packed_module()
    seen = []

    def fake_packed_call(x):
        seen.append(x.device)
        return torch.zeros((x.shape[0], 16))

    monkeypatch.setattr(PackedFusionNet, "device",
                        property(lambda self: torch.device("meta")))
    monkeypatch.setattr(net, "packed_call", fake_packed_call)
    with BatchServer(mod, batch=2, input_shape=mod.input_shape[1:]) as srv:
        srv.submit(net.example_input()[0]).result(timeout=30)
    assert seen == [torch.device("meta")]
