"""VGGFusion and BatchServer of the PyTorch port vs the JAX package.

The dense, packed and hybrid forwards on the CPU (each op's plain PyTorch
version) against the JAX ``VGGFusion`` in Pallas interpret mode, bitwise on
the f32 logits, at the JAX tests' size (tests/test_models.py:139-142); the
three full-width forwards against golden logits the JAX package wrote.
"""
import os

import numpy as np
import pytest
import torch

from deepfusion_tpu.models import VGGFusion as JVGGFusion
from deepfusion_tpu.models import VGGFusionConfig as JConfig
from deepfusion_tpu.models.fusionnet import _mkconv as j_mkconv
from deepfusion_tpu_torch.models import (PackedFusionNet, VGGFusion,
                                         VGGFusionConfig)
from deepfusion_tpu_torch.models.vggfusion import LAYERS, N_BLOCKS
from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
from deepfusion_tpu_torch.serving import BatchServer

torch.set_num_threads(2)

SMALL = dict(batch=2, hw=16, in_ch=16, width=32, num_classes=16)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "vggfusion_full_logits.npz")


@pytest.fixture(scope="module")
def jax_net():
    return JVGGFusion(JConfig(**SMALL))


@pytest.fixture(scope="module")
def net():
    return VGGFusion(VGGFusionConfig(**SMALL), device="cpu")


def _jax_params_as_numpy(cfg: dict) -> dict:
    """The JAX package's draw (vggfusion.py:53-68, its own ``_mkconv``) as
    the port's parameter dicts: the JAX model keeps the blocks' raw
    parameters but only the head's dense op."""
    c = JConfig(**cfg)
    rng = np.random.default_rng(c.seed)
    n, h = c.batch, c.hw
    chans = [c.in_ch] + [c.width * (1 << b) for b in range(N_BLOCKS)]
    raw = []
    for b in range(N_BLOCKS):
        p1, s = j_mkconv(rng, n, h, h, chans[b], chans[b + 1], 3, 1, 1, "u8",
                         in_std=74.0 if b == 0 else 30.0)
        p2, s = j_mkconv(rng, n, s[1], s[2], chans[b + 1], chans[b + 1], 3,
                         1, 1, "u8")
        raw += [p1, p2]
        h //= 2
    head, _ = j_mkconv(rng, n, 1, 1, chans[-1], c.num_classes, 1, 0, 1, "f32",
                       relu=False)
    out = {}
    for name, p in zip(LAYERS, raw + [head]):
        out[name] = dict(wei=np.asarray(p.wei), bia=np.asarray(p.bia),
                         conv0_scales=np.asarray(p.cfg.conv0_scales,
                                                 np.float32),
                         conv0_relu=p.cfg.conv0_relu,
                         dst_dt=p.cfg.dst_dt.name)
    return out


def test_random_params_equal_jax_params(jax_net, net):
    ref = _jax_params_as_numpy(SMALL)
    # the helper's draw is the JAX model's: its blocks hold the same arrays
    for b, (p1, p2) in enumerate(jax_net.block_params):
        for i, p in ((1, p1), (2, p2)):
            np.testing.assert_array_equal(
                ref[f"block{b + 1}_conv{i}"]["wei"], np.asarray(p.wei))
    for name in LAYERS:
        got, want = net.params[name], ref[name]
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v,
                                          err_msg=f"{name}.{k}")


def test_layer_configs_match_jax(jax_net, net):
    for b, (p1, p2) in enumerate(jax_net.block_params):
        for conv, jp in ((net.conv1[b], p1), (net.convpool2[b], p2)):
            for f in ("ih", "iw", "ic", "oh", "ow", "oc", "kh", "sh", "ph",
                      "fuse_conv1x1", "conv0_relu"):
                assert getattr(conv.cfg, f) == getattr(jp.cfg, f), (b, f)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("path", ["dense", "packed", "hybrid"])
def test_forward_matches_jax(path, seed, jax_net, net):
    x = net.example_input(np.random.default_rng(seed))
    jfn = {"dense": jax_net, "packed": jax_net.packed_call,
           "hybrid": jax_net.hybrid_call}[path]
    fn = {"dense": net, "packed": net.packed_call,
          "hybrid": net.hybrid_call}[path]
    want = np.asarray(jfn(x))
    with torch.inference_mode():
        got = fn(x).numpy()
    assert got.shape == (2, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_from_numpy_params_matches_jax(jax_net):
    x = jax_net.example_input(np.random.default_rng(5))
    net2 = VGGFusion.from_numpy_params(VGGFusionConfig(**SMALL),
                                       _jax_params_as_numpy(SMALL),
                                       device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(net2(x).numpy(),
                                      np.asarray(jax_net(x)))


def test_packed_specs_match_jax_build_packed(jax_net, net):
    jpairs, jfinal = jax_net.build_packed()
    pairs = net.build_packed()
    assert len(pairs) == len(jpairs) == N_BLOCKS
    for pair, jpair in zip(pairs, jpairs):
        assert isinstance(pair, PackedConvPairOp) and pair.pool2
        for s in ("sin", "smid", "sout", "sout_pooled"):
            assert vars(getattr(pair, s)) == vars(getattr(jpair, s)), s
    assert vars(pairs[-1].sout_pooled) == vars(jfinal)
    assert net.build_packed() is pairs     # built once


@pytest.fixture(scope="module")
def full_net():
    return VGGFusion(VGGFusionConfig(), device="cpu")


@pytest.mark.parametrize("path", ["dense", "packed", "hybrid"])
def test_full_width_matches_jax_golden_logits(path, full_net):
    """VGGFusionConfig() at its published width (batch 8, 56x56x32 in,
    widths 64/128/256) against logits the JAX package's dense forward wrote
    (tests/data/make_vggfusion_full_logits.py), on each forward."""
    golden = np.load(GOLDEN)
    assert int(golden["model_seed"]) == full_net.cfg.seed
    x = full_net.example_input(
        np.random.default_rng(int(golden["input_seed"])))
    fn = {"dense": full_net, "packed": full_net.packed_module(),
          "hybrid": full_net.hybrid_call}[path]
    with torch.inference_mode():
        got = fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, golden["logits"])


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
