"""The check on the CPU: a sound run comes out correct, and a run whose
timed path is broken underneath, or whose program is replaced by the int4
control, comes out not correct, in every cell.

The faults a cell can have: a call that returns its state unchanged (the
first call's result, every time), half of the batch left out (the second
half copies the first), one answer altered where it is produced (one logit
moved by one ulp). These cells run on one chip, so no exchange between
chips can be left out."""
import numpy as np
import pytest
import torch

from portbench import control, harness, system

CELLS = ["fusionnet-packed-offline-b256", "vggfusion-dense-offline-b256",
         "fusionnet-dense-served-poisson", "vggfusion-dense-served-closed64"]


class Broken:
    """A compiled callable with a fault planted in what it returns."""

    def __init__(self, entry, fault: str):
        self.entry, self.fault = entry, fault
        self.device, self.input_shape = entry.device, entry.input_shape
        self.first = None

    def __call__(self, x):
        out = self.entry(x).clone()
        if self.fault == "stale":
            if self.first is None:
                self.first = out
            return self.first.clone()
        if self.fault == "half":
            h = out.shape[0] // 2
            out[out.shape[0] - h:] = out[:h]
        elif self.fault == "altered":
            out[0, 0] = torch.nextafter(out[0, 0], torch.tensor(np.inf))
        return out


def run(bench, root, cell, build, seed=2 ** 31 + 11):
    out, _ = harness.run_cell(bench, cell, seed, 0.4, False, "cpu", 0.0,
                              build=build, root=root)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_bench, tiny_root, cell):
    out = run(tiny_bench, tiny_root, cell, system.build)
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_checked"]["value"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_bench, tiny_root, cell,
                                            fault):
    def build(*a):
        return Broken(system.build(*a), fault)
    out = run(tiny_bench, tiny_root, cell, build)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_int4_control_is_not_correct(tiny_bench, tiny_root, cell):
    rows = control.readings(tiny_bench, cell, [3, 4, 5], 0.4, "cpu", True,
                            root=tiny_root)
    assert [correct for _, correct, _ in rows] == [False] * 3
    for _, _, checks in rows:
        assert checks["logit_max_abs_diff"]["value"] > 0
