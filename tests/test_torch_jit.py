"""The models' compiled callables ``jit()`` and ``jit_packed()`` of the
PyTorch port vs the JAX package's.

On the CPU a ``GraphedForward`` calls the forward (no graph), so each case
holds the port's callable against the JAX package's ``net.jit()(x)`` and
``net.jit_packed()(x)`` (Pallas interpret mode) bitwise, on the same seeded
numpy inputs, at the sizes the port's model tests use. The capture and
replay run on the card only (``chip_smoke.py``'s ``graphs:`` lines); their
launch accounting (``counted``, ``_build.add_counts``) is pure Python and is
held here.
"""
import numpy as np
import pytest
import torch

from deepfusion_tpu import models as jmodels
from deepfusion_tpu_torch import _build
from deepfusion_tpu_torch import models as tmodels
from deepfusion_tpu_torch.models.graphed import GraphedForward, counted
from deepfusion_tpu_torch.serving import BatchServer, model_device

torch.set_num_threads(2)

# tests/test_torch_fusionnet.py:22-24, test_torch_resfusion.py:24-26,
# test_torch_vggfusion.py:25
SIZES = {
    ("FusionNet", "jit"): dict(batch=1, hw=8, in_ch=16, width=32,
                               num_classes=16),
    ("FusionNet", "jit_packed"): dict(batch=2, hw=24, in_ch=32, width=64,
                                      num_classes=32),
    ("ResFusionNet", "jit"): dict(batch=1, hw=16, in_ch=16, width=32,
                                  num_classes=16),
    ("ResFusionNet", "jit_packed"): dict(batch=2, hw=32, in_ch=16, width=64,
                                         num_classes=32),
    ("VGGFusion", "jit"): dict(batch=2, hw=16, in_ch=16, width=32,
                               num_classes=16),
    ("VGGFusion", "jit_packed"): dict(batch=2, hw=16, in_ch=16, width=32,
                                      num_classes=16),
}


def _nets(model: str, size: dict):
    """The JAX model and the port's on the CPU, same config and seed."""
    jnet = getattr(jmodels, model)(getattr(jmodels, f"{model}Config")(**size))
    tnet = getattr(tmodels, model)(getattr(tmodels, f"{model}Config")(**size),
                                   device="cpu")
    return jnet, tnet


@pytest.mark.parametrize("model,method", list(SIZES))
def test_compiled_callable_matches_jax(model, method):
    jnet, tnet = _nets(model, SIZES[(model, method)])
    x = tnet.example_input(np.random.default_rng(11))
    want = np.asarray(getattr(jnet, method)()(x))
    fn = getattr(tnet, method)()
    assert isinstance(fn, GraphedForward)
    got = fn(x)
    assert got.device.type == "cpu" and fn.captures == 0
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batch_server_serves_jit():
    """tests/test_serving.py::test_with_fusionnet through the port: 6
    requests at batch 4; equal inputs give equal logits in any slot, and
    the JAX package's compiled forward's."""
    size = dict(batch=4, hw=8, in_ch=16, width=32, num_classes=16)
    jnet, tnet = _nets("FusionNet", size)
    fwd = tnet.jit()
    xs = [tnet.example_input()[0] for _ in range(6)]
    with BatchServer(fwd, batch=4, input_shape=(8, 8, 16)) as srv:
        outs = [f.result(timeout=60) for f in srv.submit_many(xs)]
    assert all(o.shape == (16,) for o in outs)
    assert np.array_equal(outs[0], outs[5])
    want = np.asarray(jnet.jit()(np.stack(xs[:4])))
    for o in outs:
        np.testing.assert_array_equal(o, want[0])


@pytest.mark.parametrize("method", ["jit", "jit_packed"])
def test_callable_carries_device_and_input_shape(method):
    _, tnet = _nets("FusionNet", SIZES[("FusionNet", method)])
    fn = getattr(tnet, method)()
    assert fn.device == torch.device("cpu") == model_device(fn)
    assert fn.input_shape == tnet.input_shape


@pytest.mark.parametrize("method", ["jit", "jit_packed"])
def test_result_survives_a_later_call(method):
    _, tnet = _nets("ResFusionNet", SIZES[("ResFusionNet", method)])
    fn = getattr(tnet, method)()
    rng = np.random.default_rng(3)
    x1, x2 = tnet.example_input(rng), tnet.example_input(rng)
    first = fn(x1)
    kept = first.clone()
    second = fn(x2)
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    torch.testing.assert_close(second, tnet(x2), rtol=0, atol=0)


@pytest.mark.parametrize("method", ["jit", "jit_packed"])
def test_second_batch_size_gives_the_forward(method):
    _, tnet = _nets("VGGFusion", SIZES[("VGGFusion", method)])
    fn = getattr(tnet, method)()
    rng = np.random.default_rng(4)
    for n in (tnet.cfg.batch, 3):
        x = rng.integers(0, 256, (n,) + tnet.input_shape[1:], dtype=np.uint8)
        got = fn(x)
        assert got.shape == (n, tnet.cfg.num_classes)
        torch.testing.assert_close(got, tnet(x), rtol=0, atol=0)


def test_capture_delta_moves_to_replays():
    """A simulated capture: the forward's counts are taken out after it
    ran (``counted``) and put back once per replay, so three replays
    leave three forwards' worth."""
    def forward(x):
        _build.count_launch("conv_fused")
        _build.count_launch("conv_fused", "acc1")
        _build.count_launch("pool")
        return x + 1

    _build.reset_launch_counts()
    out, delta = counted(forward, 1)
    assert out == 2
    assert delta == {"conv_fused": 2, "pool": 1, "conv_fused.acc1": 1}
    assert not any(_build.launch_counts().values())
    assert not any(_build.mode_counts().values())
    for _ in range(3):
        _build.add_counts(delta)
    assert _build.launch_counts() == {**dict.fromkeys(_build.KERNELS, 0),
                                      "conv_fused": 6, "pool": 3}
    assert _build.mode_counts() == {**dict.fromkeys(_build.MODES, 0),
                                    "conv_fused.acc1": 3}
    _build.reset_launch_counts()


def test_snapshot_counts_holds_every_kernel_and_mode():
    _build.reset_launch_counts()
    _build.count_launch("packed_conv", "rows")
    snap = _build.snapshot_counts()
    assert set(snap) == set(_build.KERNELS) | set(_build.MODES)
    assert snap["packed_conv"] == 1 and snap["packed_conv.rows"] == 1
    _build.add_counts({"packed_conv": 1, "packed_conv.rows": 1}, -1)
    assert not any(_build.snapshot_counts().values())
