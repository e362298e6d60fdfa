"""The harness's parts on the CPU: lookups by name, the Poisson schedule,
percentiles, the trace's idle share, the contract's shape of
BENCHMARK.json, and the refusal to run without a card."""
import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness, spec, stats, trace
from portbench.traffic import poisson

from conftest import REPO, tiny_copy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in b["workloads"]:
        got = {m["name"] for m in spec.metrics(b, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics(b, w["name"], True)
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_parts():
    b = spec.load()
    for w in b["workloads"]:
        cfg = spec.config(b, w["config"])
        mix = spec.traffic(w["traffic"])
        assert spec.loop(mix).Loop and spec.reference(cfg).forward
        for m in spec.metrics(b, w["name"], False) + spec.metrics(
                b, w["name"], True):
            assert callable(spec.reader(m["name"]))


def test_a_cell_added_as_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric, added
    as new files and entries of BENCHMARK.json, with no other edit: the
    harness finds them by name and the run reports the new metric."""
    root = tiny_copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "fusionnet.json").read_text())
    (pb / "configs" / "fusionnet-wide.json").write_text(json.dumps(
        dict(cfg, width=128)))
    (pb / "workloads" / "dense-offline-b2.json").write_text(json.dumps(
        {"loop": "offline", "entry": "jit", "batch": 2, "ring": 2}))
    (pb / "metrics" / "model.calls.py").write_text(
        "def read(run):\n    return run.calls\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append(dict(b["configs"][0], name="fusionnet-wide",
                             file="portbench/configs/fusionnet-wide.json"))
    b["workloads"].append(dict(name="wide-dense-offline-b2",
                               config="fusionnet-wide",
                               traffic="dense-offline-b2", chips=1,
                               why="a test"))
    e2e = next(m for m in b["end_to_end"] if m["name"] == "images_per_s")
    e2e["workloads"].append("wide-dense-offline-b2")
    b["per_layer"].append(dict(name="model.calls", unit="calls",
                               better="higher", source="program_counter",
                               layer="model", moves="images_per_s",
                               workloads=["wide-dense-offline-b2"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    bench = spec.load(root)
    assert spec.config(bench, "fusionnet-wide", root)["width"] == 128
    out, run = harness.run_cell(bench, "wide-dense-offline-b2", 7, 0.3, True,
                                "cpu", 0.0, root=root)
    assert out["correct"] and run.batch == 2
    assert out["metrics"]["model.calls"]["value"] == run.calls > 0
    out, _ = harness.run_cell(bench, "wide-dense-offline-b2", 7, 0.3, False,
                              "cpu", 0.0, root=root)
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}


def test_poisson_schedule_is_the_seeds_and_only_its_order():
    a = poisson.schedule(1000.0, 2.0, 2 ** 31 + 5)
    assert np.array_equal(a, poisson.schedule(1000.0, 2.0, 2 ** 31 + 5))
    b = poisson.schedule(1000.0, 2.0, 2 ** 31 + 6)
    assert len(a) == len(b) == 2000 and a[0] == b[0] == 0.0
    assert not np.array_equal(a, b)
    ga = np.sort(np.diff(np.append(a, 2.0)))
    gb = np.sort(np.diff(np.append(b, 2.0)))
    assert np.allclose(ga, gb, rtol=0, atol=1e-12)
    assert np.all(np.diff(a) > 0) and a[-1] < 2.0
    # exponential gaps: mean 1/rate, about as many above it as a Poisson
    # process leaves (exp(-1) of them)
    assert np.mean(ga) == pytest.approx(1e-3, rel=1e-9)
    assert np.mean(ga > 1e-3) == pytest.approx(math.exp(-1), abs=0.01)


def test_percentiles_take_every_request_and_rank_missing_last():
    v = np.arange(1, 101, dtype=float)
    assert stats.percentile(v, 50) == 50 and stats.percentile(v, 95) == 95
    assert stats.percentile(np.append(v[:-1], np.inf), 95) == 95
    v[-6:] = np.inf
    assert stats.percentile(v, 95) == np.inf
    assert stats.percentile(np.array([3.0]), 95) == 3.0


def test_idle_share_and_gaps_from_a_synthetic_trace():
    ev = [dict(ph="X", cat="user_annotation", name=trace.START, ts=1000.0,
               dur=1.0),
          dict(ph="X", cat="user_annotation", name=trace.END, ts=2000.0,
               dur=1.0),
          # two overlapping kernels, a copy, one kernel outside the window
          dict(ph="X", cat="kernel", name="k1", ts=1100.0, dur=200.0),
          dict(ph="X", cat="kernel", name="k2", ts=1200.0, dur=200.0),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=1900.0,
               dur=200.0),
          dict(ph="X", cat="kernel", name="k1", ts=500.0, dur=100.0),
          dict(ph="X", cat="gpu_user_annotation", name="x", ts=1000.0,
               dur=1000.0),
          # the host: an op over the long gap, a shorter one nested in it
          dict(ph="X", cat="cpu_op", name="aten::to", ts=1400.0, dur=500.0),
          dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
               ts=1500.0, dur=390.0)]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [1100, 1400] and [1900, 2000]
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["kernel_s"] == pytest.approx(400e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    assert dict((k, v) for k, v in s["idle_gaps"]) == {
        trace.NO_HOST_OP: pytest.approx(100e-6),
        "cudaStreamSynchronize": pytest.approx(500e-6)}

    class R:
        trace = s
    assert stats.idle_share_pct(R) == pytest.approx(60.0)
    assert trace.summarize(ev[2:]) is None


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device here: a non-zero exit and no result line."""
    p = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
         "fusionnet-packed-offline-b256", "--seed", "2147483700",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0
    assert "correct" not in p.stdout and "CUDA" in p.stderr
