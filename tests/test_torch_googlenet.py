"""GoogLeNet (Inception-v1) of the PyTorch port on the CPU (each op's plain
PyTorch version) against the benchmark's plain reference
(``portbench/reference/googlenet.py``), which shares no code with it.

At the published widths (Table 1's, 1,000 classes) on 64x64 images,
bitwise on the f32 logits, on the benchmark's own weights; the counts at
224; the calibration's hold on each module's output; the ceil-mode and
branch pools; the ``model.layer`` spans and the concat's attrs; and the
reader of ``kernels.concat_roofline``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepfusion_tpu_torch.config import PoolConfig
from deepfusion_tpu_torch.models import GoogLeNet, GoogLeNetConfig
from deepfusion_tpu_torch.models.googlenet import MODULES, layer_plan
from deepfusion_tpu_torch.ops.pool import pool
from deepfusion_tpu_torch.utils import profiler
from portbench import counts, harness, spec, weights
from portbench.reference import googlenet as ref

PUBLISHED = dict(in_ch=3, num_classes=1000)
SMALL = dict(PUBLISHED, hw=64)     # pools 32 -> 16 -> 8 -> 4 -> 2
H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
# each module's outputs at 255 with the seeded calibration: under 1% at
# 224 and 64 for the seeds tried
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
    net = GoogLeNet.from_numpy_params(GoogLeNetConfig(batch=2, **SMALL),
                                      params, device="cpu")
    got = net.jit()(x).numpy()
    expected = harness.reference_logits(ref, params, x)
    assert got.shape == (2, 1000) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), expected.view(np.uint32))
    assert (got[0] != got[1]).any()


def test_counts_at_224():
    """Table 1's 57 convs and the head: 1,582,671,872 MACs an image and
    6,990,272 weights; the 3x3s are 61% of the MACs (the modules' own 39%,
    conv2's 22%)."""
    layers = ref.layers(dict(PUBLISHED, hw=224))
    assert len(layers) == 58
    assert counts.model_macs(layers) == 1_582_671_872
    assert sum(l["k"] ** 2 * l["ic"] * l["oc"] for l in layers) == 6_990_272
    by_k = {k: sum(counts.macs(l) for l in layers if l["k"] == k)
            for k in (1, 3, 5, 7)}
    assert by_k[3] / counts.model_macs(layers) == pytest.approx(0.6083,
                                                                abs=1e-4)
    assert sum(by_k.values()) == counts.model_macs(layers)
    assert [l["concat"] for l in layers if "concat" in l] == [
        256, 480, 512, 512, 512, 528, 832, 832, 1024]
    assert counts.model_bound_s(layers, 256, H100) * 1e3 == pytest.approx(
        0.6992, abs=1e-4)


def test_the_model_and_the_reference_list_the_same_layers():
    """Names, shapes, strides, destinations and calibration: the model's
    ``random_params`` and the benchmark's draw hold the same layers."""
    for cfg in (SMALL, dict(PUBLISHED, hw=224)):
        mine = layer_plan(GoogLeNetConfig(**cfg))
        theirs = ref.layers(cfg)
        assert [l.name for l in mine] == [l["name"] for l in theirs]
        for a, b in zip(mine, theirs):
            assert (a.k, a.ic, a.oc, a.stride, a.dst, a.relu, a.in_std) == (
                b["k"], b["ic"], b["oc"], b["stride"], b["dst"], b["relu"],
                b["in_std"])
            assert b["oc1x1"] is None
            assert b["hw"] == -(-a.in_hw // a.stride)    # the output's
        assert [l.kind for l in mine].count("b5x5") == 9


@pytest.mark.parametrize("seed", [0, 1])
def test_no_module_saturates(seed):
    """Logits differ between images, and no module's concat holds 255 in
    more than SATURATED_CEILING of its values, nor is mostly zero."""
    net = GoogLeNet(GoogLeNetConfig(batch=2, seed=seed, **SMALL),
                    device="cpu")
    seen = {}
    inception = net.inception
    net.inception = lambda m, x: seen.setdefault(m, inception(m, x))
    logits = net.jit()(net.example_input(np.random.default_rng(seed)))
    assert (logits[0] != logits[1]).any()
    assert logits.std() > 1.0
    assert list(seen) == [m for m, *_ in MODULES]
    for (m, n1, _, n3, _, n5, pp), out in zip(MODULES, seen.values()):
        assert out.dtype == torch.uint8 and out.shape[-1] == n1 + n3 + n5 + pp
        assert (out == 255).float().mean() < SATURATED_CEILING, m
        assert (out == 0).float().mean() < 0.75, m


def test_the_pools_take_ceil_mode_sizes():
    """112 -> 56 -> 28 -> 14 -> 7 by the 3x3/s2 pools with no padding in
    ceil mode, the branch pool keeps its size, and each port pool equals
    the reference's and torch's max_pool2d (ceil mode) on u8 values."""
    sizes = [112]
    for _ in range(4):
        sizes.append(PoolConfig.make("max", (sizes[-1],) * 2, (3, 3), (2, 2),
                                     (0, 0)).oh)
    assert sizes == [112, 56, 28, 14, 7]
    assert [ref.pooled(h) for h in sizes[:-1]] == sizes[1:]
    assert PoolConfig.make("max", (28, 28), (3, 3), (2, 2), (0, 0),
                           ceil_mode=False).oh == 13     # floor mode's
    rng = np.random.default_rng(3)
    for h in (18, 15, 7):
        x = torch.from_numpy(rng.integers(0, 256, (2, h, h, 16)
                                          ).astype(np.uint8))
        nchw = x.permute(0, 3, 1, 2).float()
        s2 = pool(x, "max", (3, 3), (2, 2), (0, 0), device="cpu")
        s1 = pool(x, "max", (3, 3), (1, 1), (1, 1), device="cpu")
        assert s2.shape[1] == ref.pooled(h) and s1.shape[1] == h
        assert torch.equal(s2.float(), ref.maxpool3s2_ceil(x.float()))
        assert torch.equal(s1.float(), ref.maxpool3s1(x.float()))
        assert torch.equal(s2, F.max_pool2d(nchw, 3, 2, ceil_mode=True)
                           .permute(0, 2, 3, 1).to(torch.uint8))
        assert torch.equal(s1, F.max_pool2d(nchw, 3, 1, 1)
                           .permute(0, 2, 3, 1).to(torch.uint8))


def test_layer_spans_in_order_with_their_kinds():
    net = GoogLeNet(GoogLeNetConfig(batch=1, **SMALL), device="cpu")
    x = net.example_input()
    profiler.clear_spans()
    net(x)                                   # off: nothing recorded
    assert profiler.spans() == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net(x)
    recs = [r for r in profiler.spans() if r.name == "model.layer"]
    profiler.clear_spans()
    module = ["b1x1", "b3x3_reduce", "b3x3", "b5x5_reduce", "b5x5",
              "branch_pool", "pool_proj", "concat"]
    kinds = ["stem", "maxpool", "reduce", "conv", "maxpool"]
    for m, *_ in MODULES:
        kinds += (["maxpool"] if m in ("4a", "5a") else []) + module
    kinds += ["avgpool", "head"]
    assert [r.attrs["kind"] for r in recs] == kinds
    names = [r.attrs["name"] for r in recs]
    assert names[:5] == ["stem", "pool1", "conv2_reduce", "conv2", "pool2"]
    assert names[-2:] == ["avgpool", "head"]
    convs = [n for n, k in zip(names, kinds) if k not in (
        "maxpool", "branch_pool", "concat", "avgpool")]
    assert convs == [l.name for l in layer_plan(net.cfg)] == list(net.convs)
    # the launches a forward makes on the card: K1 58, K2 9, K3 14
    assert (len(convs), kinds.count("concat"),
            kinds.count("maxpool") + kinds.count("branch_pool")
            + kinds.count("avgpool")) == (58, 9, 14)
    cat = [r.attrs for r in recs if r.attrs["kind"] == "concat"]
    assert [a["name"] for a in cat] == [f"{m}_concat" for m, *_ in MODULES]
    assert [a["inputs"] for a in cat] == [4] * 9
    assert [a["lanes"] for a in cat] == [l["concat"] for l in ref.layers(
        SMALL) if "concat" in l]
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert all(a.end_ns <= b.start_ns for a, b in zip(recs, recs[1:]))


def _record(device_ops, units=4, batch=256):
    run = harness.Run(cell="googlenet-dense-offline-b256", batch=batch,
                      layers=ref.layers(dict(PUBLISHED, hw=224)), seconds=1,
                      peak=H100)
    run.trace = dict(window_s=3.0, busy_s=2.9, kernel_s=2.8,
                     device_ops=device_ops, idle_gaps=[])
    run.traced_units = units
    return run


def test_the_concat_roofline_reader():
    """The nine concats' bound at batch 256, each output byte written once
    and each input byte read once at 3.35 TB/s: 0.18884 ms; the reader
    divides it by the traced K2 time per call and reads nothing without
    K2 ops, calls or a trace."""
    read = spec.reader("kernels.concat_roofline")
    px_lanes = (28 * 28 * (256 + 480) + 14 * 14 * (512 * 3 + 528 + 832)
                + 7 * 7 * (832 + 1024))
    assert px_lanes == 1_235_584
    bound = 2 * 256 * px_lanes / H100["bytes_per_s"]
    assert bound * 1e3 == pytest.approx(0.18884, abs=1e-5)
    ops = [["void concat_relu_kernel(ConcatArgs, int)", 0.004],
           ["void (anonymous namespace)::conv_fused_kernel<false, 4>("
            "(anonymous namespace)::Maps, (anonymous namespace)::KArgs)",
            0.5],
           ["Memcpy DtoH (Device -> Pageable)", 0.01]]
    assert read(_record(ops)) == pytest.approx(100 * bound / (0.004 / 4))
    ops[0][0] = "void_concat_relu_kernel_ConcatArgs__int_"   # the ledger's
    assert read(_record(ops)) == pytest.approx(100 * bound / (0.004 / 4))
    assert read(_record(ops[1:])) is None
    assert read(_record(ops, units=0)) is None
    run = _record(ops)
    run.trace = None
    assert read(run) is None
