"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
whose configurations and traffic are cut to a size the CPU runs in
seconds (widths the packed forward still accepts), driven on the port's
CPU path."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {"fusionnet": dict(hw=24, in_ch=32, width=64, num_classes=32),
                "vggfusion": dict(hw=16, in_ch=16, width=32, num_classes=16)}


# The open-loop cell that BENCHMARK.json leaves out for now (PERF.md, open
# questions), with its metrics: its traffic and readers are kept and tested.
OPEN_LOOP = "fusionnet-dense-served-poisson"
OPEN_LOOP_ENTRIES = {
    "workloads": [dict(name=OPEN_LOOP, config="fusionnet",
                       traffic="dense-served-poisson", chips=1,
                       why="single images at Poisson arrivals")],
    "end_to_end": [dict(name=n, unit="ms", better="lower", bound=0.25,
                        source="host_clock", workloads=[OPEN_LOOP])
                   for n in ("latency_p50_ms", "latency_p95_ms")],
    "per_layer": [dict(name=n, unit=u, better=b, source=s, layer=layer,
                       moves="latency_p95_ms", workloads=[OPEN_LOOP])
                  for n, u, b, s, layer in (
                      ("serve.batch_fill", "%", "higher", "program_counter",
                       "serving"),
                      ("loadgen.late_p95_ms", "ms", "lower", "host_clock",
                       "load generator"),
                      ("device.idle_share.poisson", "%", "lower",
                       "device_trace", "device"))]}


def tiny_copy(dest: Path) -> Path:
    """BENCHMARK.json (with the open-loop cell) and portbench/ copied
    under `dest`, cut down."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in OPEN_LOOP_ENTRIES.items():
        bench[key] += entries
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, sizes in TINY_CONFIGS.items():
        p = dest / "portbench" / "configs" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **sizes}))
    for p in (dest / "portbench" / "workloads").glob("*.json"):
        mix = json.loads(p.read_text())
        mix["batch"] = 4 if mix["loop"] == "offline" else 2
        mix.update({k: v for k, v in dict(pool=16, rate_per_s=40,
                                          clients=3).items() if k in mix})
        p.write_text(json.dumps(mix))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_bench(tiny_root) -> dict:
    from portbench import spec
    return spec.load(tiny_root)
