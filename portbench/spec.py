"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics. Everything that belongs to one of them is a file of its own,
found by name, so that a later change adds a cell, a configuration, a
traffic mix or a metric by adding files:

* a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``reference`` key names its plain model ``reference/<ref>.py``;
* a traffic mix: ``workloads/<traffic>.json``, whose ``loop`` key names the
  kind of loop ``traffic/<loop>.py`` that runs it;
* a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns its value
  or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(name: str, root: Path = ROOT) -> dict:
    path = Path(root) / "portbench" / "workloads" / f"{name}.json"
    return json.loads(path.read_text())


def reference(cfg: dict):
    """The configuration's plain model module."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def loop(traffic_mix: dict):
    """The module that runs this kind of loop."""
    return importlib.import_module(f"portbench.traffic.{traffic_mix['loop']}")


def metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end
    metrics untraced, its per-layer metrics traced. An entry with a
    ``workloads`` list is reported in those cells; an end-to-end entry
    without one in every cell; a per-layer entry without one in every cell
    that reports the end-to-end metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py``, loaded from its file (a metric's
    name may hold dots)."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
