"""The check on the CPU in the MobileNetV2 offline cell, as
``test_portbench_faults.py`` holds the others: a sound run is correct; a
stale result, half a batch copied, one logit moved by an ulp and the int4
control are not. MobileNetV2 runs at its published
widths on 40x40 images (every layer kind is there: the stem, the 17 blocks
with their expands over the s8 stream, depthwise layers at both strides,
projections with and without the residual join, the last 1x1, the global
pool and the head). Also the configuration's file, the depthwise weights'
shape as drawn, and ``kernels.depthwise_roofline``'s bound."""
import json

import pytest
import torch

from portbench import control, counts, harness, spec, system, weights
from portbench.reference import mobilenetv2 as ref
from portbench.traffic import offline

from conftest import REPO, tiny_copy
from test_portbench_faults import Broken

MOBILENET = "mobilenetv2-dense-offline-b256"
CELLS = [MOBILENET]
TINY_MOBILENET = dict(hw=40)
# a seed whose kept calls are the first and the second (the offline loop
# keeps one call in KEEP from the seed's offset), and a window that makes
# the second call however slow the CPU is: a stale result shows there
SEED = 2 ** 31 + offline.KEEP + 1


def run(bench, root, cell, build):
    out, _ = harness.run_cell(bench, cell, SEED, 1.0, False, "cpu", 0.0,
                              build=build, root=root)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the many small ops, each a parallel region,
    slow to seconds a call where test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("tiny_mobilenetv2"))
    p = root / "portbench" / "configs" / "mobilenetv2.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **TINY_MOBILENET}))
    return root


@pytest.fixture(scope="module")
def bench(root):
    return spec.load(root)


def test_the_configuration_is_the_published_one():
    """Table 2 at width 1.0 and 224x224, nothing reduced; the draw gives
    each depthwise layer PyTorch's depthwise shape (c, 1, 3, 3)."""
    b = spec.load()
    cfg = spec.config(b, "mobilenetv2")
    assert (cfg["model"], cfg["reference"], cfg["hw"], cfg["in_ch"],
            cfg["num_classes"], cfg["reduced"]) == (
        "MobileNetV2", "mobilenetv2", 224, 3, 1000, [])
    entry = next(c for c in b["configs"] if c["name"] == "mobilenetv2")
    assert entry["reduced"] == [] and "1801.04381" in entry["source"]
    layers = ref.layers(dict(cfg, hw=40))
    params = weights.draw(layers, weights.generator(3, "cpu"), "cpu")
    for l in layers:
        shape = params[l["name"]]["wei"].shape
        assert shape == ((l["oc"], 1, 3, 3) if l.get("depthwise")
                         else (l["oc"], l["ic"], l["k"], l["k"]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(bench, root, cell):
    out = run(bench, root, cell, system.build)
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_checked"]["value"] >= 1


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(bench, root, cell, fault):
    def build(*a):
        return Broken(system.build(*a), fault)
    out = run(bench, root, cell, build)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_int4_control_is_not_correct(bench, root, cell):
    rows = control.readings(bench, cell, [3, 4, 5], 0.4, "cpu", True,
                            root=root)
    assert [correct for _, correct, _ in rows] == [False] * 3
    for _, _, checks in rows:
        assert checks["logit_max_abs_diff"]["value"] > 0


def test_the_cell_reports_its_metrics(bench, root):
    """The cell's end-to-end metrics untraced, and its per-layer metrics by
    name (on the CPU the device readers have nothing to read)."""
    out, run_ = harness.run_cell(bench, MOBILENET, SEED, 0.5, False, "cpu",
                                 0.0, root=root)
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    assert run_.layers[-1]["name"] == "head"
    traced = {m["name"] for m in spec.metrics(bench, MOBILENET, True)}
    assert traced == {"model.forward_ms", "model.mfu",
                      "kernels.forward_roofline", "device.idle_share.offline",
                      "model.replay_host_us", "kernels.depthwise_roofline"}


def test_the_depthwise_roofline_bound():
    """MobileNetV2's 17 depthwise layers at batch 256, their inputs at
    their own resolution, outputs, weights, biases and scales at 3.35
    TB/s: 0.4618 ms; the reader divides it by the traced depthwise_kernel
    time per call."""
    cfg = json.loads((REPO / "portbench" / "configs" /
                      "mobilenetv2.json").read_text())
    layers = ref.layers(cfg)
    peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    mod = spec.reader("kernels.depthwise_roofline").__globals__
    bound = sum(mod["bound_s"](l, 256, peak) for l in layers
                if l.get("depthwise"))
    assert bound * 1e3 == pytest.approx(0.4618, abs=1e-4)
    run_ = harness.Run(cell=MOBILENET, batch=256, layers=layers, seconds=1,
                       peak=peak)
    run_.trace = dict(window_s=3.0, busy_s=2.9, kernel_s=2.8, idle_gaps=[],
                      device_ops=[["depthwise_kernel(DwArgs)", 0.0024]])
    run_.traced_units = 3
    assert mod["read"](run_) == pytest.approx(100 * bound / 0.0008)
