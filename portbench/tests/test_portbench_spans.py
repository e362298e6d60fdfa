"""The readers of the program's spans (``source: program_span``) on the
CPU: a traced run of each cell (cut down) reports its span metrics as
finite numbers read from the program's own records, an untraced run none
of them, and a program that keeps no spans gives the readers nothing to
read, without an error."""
import math

import pytest

from deepfusion_tpu_torch.utils import profiler
from portbench import harness, spec

SPAN_METRICS = {
    "vggfusion-dense-served-closed64": {"serve.queue_wait_ms",
                                        "serve.gather_ms",
                                        "serve.flush_host_us"},
    "fusionnet-packed-offline-b256": {"model.replay_host_us"},
    "vggfusion-dense-offline-b256": {"model.replay_host_us"},
}
ALL = set().union(*SPAN_METRICS.values())


def _run(bench, root, cell, traced):
    profiler.clear_spans()      # one process runs several cells here
    out, run = harness.run_cell(bench, cell, 2 ** 31 + 11, 0.3, traced,
                                "cpu", 0.0, root=root)
    assert out["correct"]
    return out["metrics"], run


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_its_span_metrics(tiny_bench, tiny_root, cell):
    assert {m["name"] for m in spec.metrics(tiny_bench, cell, True)} \
        & ALL == SPAN_METRICS[cell]
    got, _ = _run(tiny_bench, tiny_root, cell, True)
    for name in SPAN_METRICS[cell]:
        v = got[name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    assert not set(got) & (ALL - SPAN_METRICS[cell])
    assert not set(_run(tiny_bench, tiny_root, cell, False)[0]) & ALL


def test_the_readers_of_a_served_run_agree_with_its_records(tiny_bench,
                                                            tiny_root):
    """The served cell's numbers are the means of its records that ended
    within the traced stretch; the flushes' own work is each flush less its
    wait and gather; the profiler's stop stretches the last flush, which
    is left out."""
    got, run = _run(tiny_bench, tiny_root, "vggfusion-dense-served-closed64",
                    True)
    recs = profiler.spans()
    end = min(r.start_ns for r in recs) + run.trace["window_s"] * 1e9
    flushes = [r for r in recs if r.name == "serve.flush"]
    assert flushes[-1].end_ns > end
    kids = {}
    for r in recs:
        if r.name in ("serve.wait", "serve.gather") and r.end_ns <= end:
            kids.setdefault(r.parent, []).append(r.end_ns - r.start_ns)
    own = [f.end_ns - f.start_ns - sum(kids[f.id]) for f in flushes
           if f.end_ns <= end and len(kids.get(f.id, ())) == 2]
    assert len(own) >= len(flushes) - 3 > 0
    assert got["serve.flush_host_us"]["value"] == pytest.approx(
        sum(own) / len(own) / 1e3)
    reqs = [r for r in recs if r.name == "serve.request" and r.end_ns <= end]
    assert got["serve.queue_wait_ms"]["value"] == pytest.approx(
        sum(r.attrs["picked"] - r.start_ns for r in reqs) / len(reqs) / 1e6)


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    """As at a commit before the spans: no ``spans`` in the profiler; and
    a run without a trace."""
    class Run:
        trace = {"window_s": 3.0}
    profiler.record("serve.flush", 0, 1, 1)
    assert spec.reader("serve.flush_host_us")(Run) is None  # no children
    Run.trace = None
    for name in ALL:
        assert spec.reader(name)(Run) is None
    Run.trace = {"window_s": 3.0}
    monkeypatch.delattr(profiler, "spans")
    for name in ALL:
        assert spec.reader(name)(Run) is None
    profiler.clear_spans()
