"""The check on the CPU in GoogLeNet's offline cell, as
``test_portbench_faults.py`` holds the others: a sound run is correct; a
stale result, half a batch copied, one logit moved by an ulp and the int4
control are not. GoogLeNet runs at its published widths on 64x64 images
(every layer kind is there: the stem and its ceil-mode pool, the 3x3 to
192, all nine modules with their 5x5s, branch pools and concats, the two
pools between them, the global pool and the head)."""
import json

import pytest
import torch

from portbench import control, harness, spec, system
from portbench.traffic import offline

from conftest import tiny_copy
from test_portbench_faults import Broken

CELLS = ["googlenet-dense-offline-b256"]
TINY_GOOGLENET = dict(hw=64)
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
    """One intra-op thread: GoogLeNet's many small ops, each a parallel
    region, slow to seconds a call where test processes share the cores,
    and the window then holds too few calls to show a stale result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("tiny_googlenet"))
    p = root / "portbench" / "configs" / "googlenet.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **TINY_GOOGLENET}))
    return root


@pytest.fixture(scope="module")
def bench(root):
    return spec.load(root)


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


def test_the_googlenet_cell_reports_its_metrics(bench, root):
    """The cell's end-to-end metrics untraced, and its per-layer metrics by
    name (on the CPU the device readers have nothing to read)."""
    out, run_ = harness.run_cell(bench, CELLS[0], SEED, 0.5, False, "cpu",
                                 0.0, root=root)
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    assert run_.layers[-1]["name"] == "head"
    traced = {m["name"] for m in spec.metrics(bench, CELLS[0], True)}
    assert {"model.forward_ms", "model.mfu", "kernels.forward_roofline",
            "device.idle_share.offline", "model.replay_host_us",
            "kernels.concat_roofline"} == traced
