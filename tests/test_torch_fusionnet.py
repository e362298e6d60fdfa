"""FusionNet and BatchServer of the PyTorch port vs the JAX package.

The dense and packed forwards on the CPU (each op's plain PyTorch version)
against the JAX ``FusionNet`` in Pallas interpret mode, bitwise on the f32
logits: every step of the integer pipeline is exact and every f32 step is
one correctly rounded IEEE operation in both packages.
"""
import os

import numpy as np
import pytest
import torch

from deepfusion_tpu.models import FusionNet as JFusionNet
from deepfusion_tpu.models import FusionNetConfig as JConfig
from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
from deepfusion_tpu_torch.models.fusionnet import LAYERS, PackedFusionNet
from deepfusion_tpu_torch.serving import BatchServer

torch.set_num_threads(2)

SMALL = dict(batch=1, hw=8, in_ch=16, width=32, num_classes=16)
# the smallest FusionNet the JAX packed geometry takes (tests/test_models.py)
PACKED = dict(batch=2, hw=24, in_ch=32, width=64, num_classes=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "fusionnet_full_logits.npz")


@pytest.fixture(scope="module")
def jax_net():
    return JFusionNet(JConfig(**SMALL))


@pytest.fixture(scope="module")
def net():
    return FusionNet(FusionNetConfig(**SMALL), device="cpu")


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
                                       _jax_params_as_numpy(jax_net),
                                       device="cpu")
    np.testing.assert_array_equal(net2(x).numpy(), np.asarray(jax_net(x)))


def test_full_width_matches_jax_golden_logits():
    """FusionNetConfig() at its published width (batch 8, 56x56, 32 -> 128
    channels) against logits the JAX package's dense forward wrote
    (tests/data/make_fusionnet_full_logits.py)."""
    golden = np.load(GOLDEN)
    cfg = FusionNetConfig()
    assert int(golden["model_seed"]) == cfg.seed
    net = FusionNet(cfg, device="cpu")
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
    model.device = torch.device("cpu")

    with BatchServer(model, batch=2, input_shape=(3,)) as srv:
        out = srv.submit(np.full((3,), 7, np.uint8)).result(timeout=30)
    np.testing.assert_array_equal(out, np.full((3,), 14, np.int32))
    assert seen and all(seen)


def test_batch_server_refuses_a_callable_without_a_device():
    """A callable that names no device (not itself, not its object) is
    refused when the server is built: its batches would otherwise be staged
    on the CPU without a word."""
    from deepfusion_tpu_torch.utils.logger import CheckError

    def model(x):
        return x
    with pytest.raises(CheckError, match="names no device"):
        BatchServer(model, batch=2, input_shape=(3,))
    net = FusionNet(FusionNetConfig(**SMALL), device="cpu")
    srv = BatchServer(net.packed_call, batch=2,
                      input_shape=net.input_shape[1:])
    assert srv._devices == [torch.device("cpu")]


@pytest.mark.parametrize("seed", [0, 3])
def test_packed_forward_matches_jax_packed_call(seed):
    jnet = JFusionNet(JConfig(**PACKED))
    tnet = FusionNet(FusionNetConfig(**PACKED), device="cpu")
    x = tnet.example_input(np.random.default_rng(seed))
    want = np.asarray(jnet.jit_packed()(x))
    with torch.inference_mode():
        got = tnet.packed_call(x).numpy()
    assert got.shape == (2, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_packed_specs_match_jax_build_packed():
    jops = JFusionNet(JConfig(**PACKED)).build_packed()
    tops = FusionNet(FusionNetConfig(**PACKED), device="cpu").build_packed()
    for name, jop in jops.items():
        top = tops[name]
        assert [vars(s) for s in top.sins] == [vars(s) for s in jop.sins]
        assert vars(top.sout) == vars(jop.sout)
    # the residual conv returns the pooled residual sum: the spec of the
    # JAX package's packed_sum_relu_maxpool2 output, block2's input
    assert vars(tops["res"].sout_final) == vars(jops["block2"].sins[0])


def test_packed_forward_launches_through_the_wrappers(monkeypatch):
    """One packed forward through the kernels' wrappers launches the
    packed conv five times, once with merge_pool (the residual sum and
    pool in the residual conv's epilogue), and the packed sum/pool kernel
    never, and still gives the dense forward's logits. Here on CPU
    tensors: each registered op is stood in by its kernel's plain
    version."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.ops import packed as T
    tnet = FusionNet(FusionNetConfig(**PACKED), device="cpu")
    by_corr = {id(op.corr0): op for op in tnet.build_packed().values()}
    conv_plain = T.packed_conv_plain
    fakes = {
        "packed_weight_maps": lambda w0k, w1k: torch.zeros(
            (6, 128), dtype=torch.uint8),
        "packed_conv": lambda arrs, cps, corr0, *rest: conv_plain(
            by_corr[id(corr0)], arrs, rest[5]),
        "packed_sum_pool": lambda ys, r, rows, iwp, pool: (
            T.packed_sum_pool_plain(ys, r, pool, rows, iwp), 1)}
    monkeypatch.setattr(_build, "op", fakes.__getitem__)
    monkeypatch.setattr(T, "packed_conv_plain", T.packed_conv_cuda)
    monkeypatch.setattr(T, "_sum_pool", T.packed_sum_pool_cuda)
    x = tnet.example_input(np.random.default_rng(5))
    _build.reset_launch_counts()
    with torch.inference_mode():
        got = tnet.packed_call(x)
    counts, modes = _build.launch_counts(), _build.mode_counts()
    _build.reset_launch_counts()
    assert counts["packed_conv"] == 5 and counts["packed_sum_pool"] == 0
    assert modes["packed_conv.merge_pool"] == 1
    with torch.inference_mode():
        assert torch.equal(got, tnet(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_forward_matches_dense(seed, net):
    x = net.example_input(np.random.default_rng(seed))
    with torch.inference_mode():
        np.testing.assert_array_equal(net.packed_call(x).numpy(),
                                      net(x).numpy())


def test_packed_full_width_matches_jax_golden_logits():
    """The packed forward at FusionNetConfig()'s published width equals the
    JAX package's golden dense logits (the packed forward is bitwise the
    dense one in both packages)."""
    golden = np.load(GOLDEN)
    cfg = FusionNetConfig()
    net = FusionNet(cfg, device="cpu")
    x = net.example_input(np.random.default_rng(int(golden["input_seed"])))
    with torch.inference_mode():
        got = net.packed_module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, golden["logits"])


def test_batch_server_packed_module_matches_direct_calls(net):
    mod = net.packed_module()
    assert isinstance(mod, PackedFusionNet)
    assert mod.device == net.device and mod.input_shape == net.input_shape
    xs = [net.example_input(np.random.default_rng(20 + i))[0]
          for i in range(5)]
    with torch.inference_mode():
        direct = [net.packed_call(x[None]).numpy()[0] for x in xs]
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
    each batch there before the packed forward sees it (a bound
    ``packed_call`` has no ``device``, so the batch would stay on the
    CPU)."""
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
    assert not hasattr(FusionNet(FusionNetConfig(**SMALL),
                                 device="cpu").packed_call,
                       "device")


def test_batch_server_over_dp_sharded_model():
    """The JAX package's ``test_server_over_sharded_model``: a FusionNet
    built at the per-shard batch 1, batch-split over a dp=2 mesh
    (``dp_shard`` of the model, one copy per slot, here both the CPU) and
    served at batch 2; bitwise against the per-example forward, and
    against the JAX package's forward of the same weights."""
    from deepfusion_tpu_torch.parallel import dp_shard, make_mesh
    cfg = dict(batch=1, hw=28, in_ch=32, width=64, num_classes=16)
    net = FusionNet(FusionNetConfig(**cfg), device="cpu")
    fwd = dp_shard(net, make_mesh(dp=2, devices=["cpu", "cpu"]))
    assert fwd.device == torch.device("cpu")
    x0, x1 = (net.example_input(np.random.default_rng(i))[0]
              for i in range(2))
    with torch.inference_mode():
        want = np.stack([net(x[None]).numpy()[0] for x in (x0, x1)])
    with BatchServer(fwd, batch=2, input_shape=net.input_shape[1:]) as srv:
        outs = [f.result(timeout=120) for f in (srv.submit(x0),
                                                 srv.submit(x1))]
    np.testing.assert_array_equal(np.stack(outs), want)
    jnet = JFusionNet(JConfig(**cfg))   # runs its batch of 1
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(jnet(x[None])) for x in (x0, x1)]), want)
