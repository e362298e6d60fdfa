"""The check on the CPU in the two offline cells that ResNet-50 v1.5 brought
(its own and VGGFusion's packed forward), as ``test_portbench_faults.py``
holds the others: a sound run is correct; a stale result, half a batch
copied, one logit moved by an ulp and the int4 control are not. ResNet-50
runs cut to 32x32 images and narrower stages (every layer kind is there:
the stem and its pool, the strided fused blocks with their s8 projections,
the identity blocks, the global pool and the head)."""
import json

import pytest
import torch

from portbench import control, harness, spec, system
from portbench.traffic import offline

from conftest import tiny_copy
from test_portbench_faults import Broken

CELLS = ["resnet50-dense-offline-b256", "vggfusion-packed-offline-b256"]
TINY_RESNET50 = dict(hw=32, width=16, num_classes=16)
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
    """One intra-op thread: ResNet-50's many small ops, each a parallel
    region, slow to seconds a call where test processes share the cores,
    and the window then holds too few calls to show a stale result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny_copy(tmp_path_factory.mktemp("tiny_resnet50"))
    p = root / "portbench" / "configs" / "resnet50.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **TINY_RESNET50}))
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
