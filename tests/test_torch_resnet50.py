"""ResNet-50 v1.5 of the PyTorch port on the CPU (each op's plain PyTorch
version) against the benchmark's plain reference
(``portbench/reference/resnet50.py``), which shares no code with it.

At the published widths (64 ... 2048 lanes, 1,000 classes) on 64x64
images, bitwise on the f32 logits, on the benchmark's own weights; the
reference's exact accumulator (stage 4's 3x3s) against int64 sums; the
counts at 224; the calibration's hold on the activations; the
``model.layer`` spans; the floor-mode max pool; and the reader of
``kernels.fused_block_roofline``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfusion_tpu_torch.config import PoolConfig
from deepfusion_tpu_torch.models import ResNet50, ResNet50Config
from deepfusion_tpu_torch.models.resnet50 import layer_plan
from deepfusion_tpu_torch.ops.conv import ConvOp, tiled_sum
from deepfusion_tpu_torch.ops.pool import pool
from deepfusion_tpu_torch.utils import profiler
from portbench import counts, harness, spec, weights
from portbench.reference import ops as ref_ops
from portbench.reference import resnet50 as ref

PUBLISHED = dict(in_ch=3, width=64, num_classes=1000)
SMALL = dict(PUBLISHED, hw=64)       # stage 4 at 2x2
TINY = dict(hw=32, in_ch=3, width=16, num_classes=16)
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
# stage 4's outputs at 255 with the seeded calibration: about 5% at 224
# (4-9% at 64), against 25% where every layer assumes an input rms of 30
SATURATED_CEILING = 0.15


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's forwards, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def drawn(seed: int, batch: int = 2, cfg=SMALL):
    """The benchmark's weights and images for `seed`, as a run draws
    them."""
    gen = weights.generator(seed, "cpu")
    params = weights.draw(ref.layers(cfg), gen, "cpu")
    x = weights.images(gen, (batch, cfg["hw"], cfg["hw"], cfg["in_ch"]),
                       "cpu")
    return params, x


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 77])
def test_jit_matches_the_reference_bitwise(seed):
    params, x = drawn(seed)
    net = ResNet50.from_numpy_params(ResNet50Config(batch=2, **SMALL),
                                     params, device="cpu")
    got = net.jit()(x).numpy()
    expected = harness.reference_logits(ref, params, x)
    assert got.shape == (2, 1000) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), expected.view(np.uint32))
    assert (got[0] != got[1]).any()


def test_stage4_3x3_needs_and_gets_the_exact_accumulator():
    rng = np.random.default_rng(20)
    wei = rng.integers(-128, 128, (8, 512, 3, 3)).astype(np.int8)
    wei[0, :, :, :] = -128          # a channel of the largest sums
    x = rng.integers(0, 256, (1, 4, 4, 512)).astype(np.float32)
    x[0, :, :, :] = 255.0
    with pytest.raises(ValueError, match="not exact"):
        ref_ops.conv_acc(torch.from_numpy(x), wei)
    got = ref.conv_acc_exact(torch.from_numpy(x), wei)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((1, 4, 4, 8), np.int64)
    for ki in range(3):
        for kj in range(3):
            want += xp[:, ki:ki + 4, kj:kj + 4, :] @ \
                wei[:, :, ki, kj].astype(np.int64).T
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert np.abs(want).max() >= ref_ops.EXACT     # beyond float32


def test_counts_at_224():
    cfg = dict(PUBLISHED, hw=224)
    layers = ref.layers(cfg)
    assert len(layers) == 38
    assert counts.model_macs(layers) == 4_089_184_256
    assert sum(l["k"] ** 2 * l["ic"] * l["oc"]
               + (l["oc1x1"] or 0) * l["oc"] for l in layers) == 25_502_912
    fused = sum(counts.macs(l) for l in layers if l["oc1x1"])
    assert fused / counts.model_macs(layers) == pytest.approx(0.6534, 1e-3)
    assert counts.model_bound_s(layers, 256, H100) * 1e3 == pytest.approx(
        1.586, abs=5e-4)


def test_the_model_and_the_reference_list_the_same_layers():
    """Names, shapes, strides, destinations and calibration: the model's
    ``random_params`` and the benchmark's draw hold the same layers."""
    for cfg in (SMALL, dict(PUBLISHED, hw=224), TINY):
        mine = layer_plan(ResNet50Config(**cfg))
        theirs = ref.layers(cfg)
        assert [l.name for l in mine] == [l["name"] for l in theirs]
        for a, b in zip(mine, theirs):
            assert (a.k, a.ic, a.oc, a.oc1x1, a.stride, a.dst, a.relu,
                    a.in_std) == (b["k"], b["ic"], b["oc"], b["oc1x1"],
                                  b["stride"], b["dst"], b["relu"],
                                  b["in_std"])
            assert b["hw"] == a.in_hw // a.stride    # the output's


@pytest.mark.parametrize("seed", [0, 1])
def test_the_seeded_calibration_keeps_activations_alive(seed):
    """Logits differ between images, and 16 residual sums do not pin stage
    4's outputs at 255."""
    net = ResNet50(ResNet50Config(batch=2, seed=seed, **SMALL),
                   device="cpu")
    seen = {}
    net.convs["s4b3_fused"].register_forward_hook(
        lambda m, a, out: seen.update(out=out))
    x = net.example_input(np.random.default_rng(seed))
    logits = net.jit()(x)
    assert (logits[0] != logits[1]).any()
    assert logits.std() > 1.0
    out = seen["out"]
    assert out.shape == (2, 2, 2, 2048) and out.dtype == torch.uint8
    assert (out == 255).float().mean() < SATURATED_CEILING
    assert 0.05 < (out == 0).float().mean() < 0.6


def test_layer_spans_in_order_with_their_kinds():
    net = ResNet50(ResNet50Config(batch=1, **TINY), device="cpu")
    x = net.example_input()
    profiler.clear_spans()
    net(x)                                   # off: nothing recorded
    assert profiler.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net(x)
    recs = [r for r in profiler.spans() if r.name == "model.layer"]
    profiler.clear_spans()
    plan = layer_plan(net.cfg)
    names = ["stem", "maxpool"] + [l.name for l in plan[1:-1]] + [
        "avgpool", "head"]
    kinds = ["stem", "maxpool"] + [l.kind for l in plan[1:-1]] + [
        "avgpool", "head"]
    assert [r.attrs["name"] for r in recs] == names
    assert [r.attrs["kind"] for r in recs] == kinds
    assert kinds.count("fused") == 16 and kinds.count("proj") == 4
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))


def test_max_pool_in_floor_mode():
    """ResNet's 3x3/s2/p1 pool: 112 -> 56 in floor mode (57 in the
    reference's ceil mode, whose first 56 rows and columns it equals);
    torch's max_pool2d on u8 values after a ReLU."""
    assert PoolConfig.make("max", (112, 112), (3, 3), (2, 2), (1, 1),
                           ceil_mode=False).oh == 56
    assert PoolConfig.make("max", (112, 112), (3, 3), (2, 2), (1, 1)).oh == 57
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 18, 18, 16)).astype(np.uint8))
    got = pool(x, "max", (3, 3), (2, 2), (1, 1), ceil_mode=False,
               device="cpu")
    ceil = pool(x, "max", (3, 3), (2, 2), (1, 1), device="cpu")
    want = F.max_pool2d(x.permute(0, 3, 1, 2).float(), 3, 2, 1)
    assert got.shape == (2, 9, 9, 16) and ceil.shape == (2, 10, 10, 16)
    assert torch.equal(got, ceil[:, :9, :9])
    assert torch.equal(got, want.permute(0, 2, 3, 1).to(torch.uint8))
    assert torch.equal(got.float(), ref.maxpool3s2(x.float()))


def _record(device_ops, units=4, batch=256):
    run = harness.Run(cell="resnet50-dense-offline-b256", batch=batch,
                      layers=ref.layers(dict(PUBLISHED, hw=224)), seconds=1,
                      peak=H100)
    run.trace = dict(window_s=3.0, busy_s=2.9, kernel_s=2.8,
                     device_ops=device_ops, idle_gaps=[])
    run.traced_units = units
    return run


def fused_bound_s(l, n):
    """A fused layer's bound at batch n: its operations, or its input at
    the input's resolution, weights, output and u8/s8 shortcut operand."""
    ops = 2 * n * counts.macs(l)
    hw, in_hw = l["hw"], l["hw"] * l["stride"]
    nbytes = (n * in_hw ** 2 * l["ic"] + counts.layer_bytes(l, 0)
              + 2 * n * hw ** 2 * l["oc1x1"])
    return max(ops / H100["int8_ops_per_s"], nbytes / H100["bytes_per_s"])


def test_the_fused_block_roofline_reader():
    read = spec.reader("kernels.fused_block_roofline")
    fused = [l for l in ref.layers(dict(PUBLISHED, hw=224)) if l["oc1x1"]]
    assert len(fused) == 16
    assert [l["sum_dt"] for l in fused] == (["s8"] + ["u8"] * 2
                                            + ["s8"] + ["u8"] * 3
                                            + ["s8"] + ["u8"] * 5
                                            + ["s8"] + ["u8"] * 2)
    bound = sum(fused_bound_s(l, 256) for l in fused)
    # stage 1's three are bound by bytes, twice counts.py's (the output
    # and the shortcut both 256 lanes wide); the strided blocks of stages
    # 2 and 3 read 4x the input pixels they write
    assert fused_bound_s(fused[0], 256) * 1e3 == pytest.approx(0.1381,
                                                               abs=1e-4)
    assert bound * 1e3 == pytest.approx(1.1054, abs=1e-4)
    ops = [["void (anonymous namespace)::conv_fused_kernel<true, 4>("
            "(anonymous namespace)::Maps, (anonymous namespace)::KArgs)",
            0.02],
           ["void (anonymous namespace)::conv_fused_kernel<false, 4>("
            "(anonymous namespace)::Maps, (anonymous namespace)::KArgs)",
            0.5],
           ["Memcpy DtoH (Device -> Pageable)", 0.01]]
    assert read(_record(ops)) == pytest.approx(100 * bound / (0.02 / 4))
    # the ledger's spelling of the same name
    ops[0][0] = "void__anonymous_namespace_::conv_fused_kernel_true__4___a"
    assert read(_record(ops)) == pytest.approx(100 * bound / (0.02 / 4))
    assert read(_record(ops[1:])) is None
    assert read(_record(ops, units=0)) is None
    run = _record(ops)
    run.trace = None
    assert read(run) is None


def test_the_fused_blocks_read_their_shortcut_as_tiles():
    """Each of the 16 fused blocks (a u8 or s8 shortcut into a u8 dst of
    256-2048 lanes) takes the kernel's tiled sum read; no other conv
    does."""
    net = ResNet50(ResNet50Config(**SMALL), device="cpu")
    tiled = [n for n, op in net.convs.items() if tiled_sum(op.cfg)]
    assert tiled == [l.name for l in layer_plan(net.cfg)
                     if l.kind == "fused"]
    assert len(tiled) == 16 and all(isinstance(net.convs[n], ConvOp)
                                    for n in tiled)
