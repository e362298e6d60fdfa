"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` draws the weights and the inputs from the seed, builds the
program's entry point (``system.build``), warms it up, and hands it to the
loop that the cell's traffic mix names. After the window it reads the
device's peak memory, frees the program, works out every input's logits
with the plain reference and compares each answer that it kept with them.
The metrics are read from the run's record (``Run``) by the readers that
``BENCHMARK.json`` names for the cell.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
import types
from typing import Any, Optional

import numpy as np
import torch

from . import counts, spec, system, trace, weights
from .reference import ops as ref_ops

REF_BLOCK = 64      # images per block of the reference


@dataclasses.dataclass
class Run:
    """What a run records for the metric readers; a field a loop does
    not fill stays None."""
    cell: str
    batch: int
    layers: list
    seconds: float
    device_kind: Optional[str] = None
    peak: Optional[dict] = None
    setup_s: Optional[float] = None
    images: Optional[int] = None           # offline: logits on the host
    forward_ms: Optional[list] = None      # offline, traced: per call
    latencies_s: Optional[np.ndarray] = None   # open loop, due -> result
    late_s: Optional[np.ndarray] = None        # open loop, due -> sent
    completed: Optional[int] = None        # closed loop, in the window
    server_delta: Optional[dict] = None    # BatchServer.stats over window
    launches: Optional[dict] = None        # kernel launches over the run
    calls: Optional[int] = None            # forwards over the run
    gc: Optional[dict] = None              # GcPauses.summary() of the run
    setup_phases: Optional[dict] = None    # seconds from start to each
    trace: Optional[dict] = None           # trace.summarize's result
    traced_units: Optional[int] = None     # calls in the traced stretch
    attempted: int = 0
    failed: int = 0


class GcPauses:
    """The interpreter's garbage collections while it is entered: count
    and longest pause per generation (``gc.callbacks``)."""

    def __enter__(self):
        self.count, self.longest, self._t = [0, 0, 0], [0.0] * 3, None
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.count[g] += 1
            self.longest[g] = max(self.longest[g],
                                  time.perf_counter() - self._t)

    def summary(self) -> dict:
        return {f"gen{g}": {"collections": self.count[g],
                            "longest_ms": 1e3 * self.longest[g]}
                for g in range(3)}


def reference_logits(ref, params: dict, inputs: torch.Tensor) -> np.ndarray:
    """The plain model's float32 logits of every input, in blocks."""
    ref_ops.strict_fp32()
    with torch.inference_mode():
        out = [ref.forward(params, inputs[i:i + REF_BLOCK]).cpu()
               for i in range(0, inputs.shape[0], REF_BLOCK)]
    return torch.cat(out).numpy()


def compare(idx: np.ndarray, got: np.ndarray, expected: np.ndarray,
            missing: int) -> dict:
    """The numbers that decide ``correct``, each with its limit: answers
    not bitwise equal to the reference's logits of their input (missing
    ones included), and the widest gap of any logit."""
    exp = expected[idx]
    if len(idx):
        same = (got.view(np.uint32) == exp.view(np.uint32)).all(axis=1)
        wrong = int((~same).sum())
        gap = float(np.max(np.abs(got.astype(np.float64) - exp)))
    else:
        wrong, gap = 0, 0.0
    return {"answers_checked": {"value": int(len(idx)) + missing,
                                "limit": 1},
            "answers_wrong": {"value": wrong + missing, "limit": 0},
            "logit_max_abs_diff": {"value": gap, "limit": 0.0}}


def passed(checks: dict) -> bool:
    """``answers_checked`` is a floor; every other number a ceiling."""
    c = checks["answers_checked"]
    return c["value"] >= c["limit"] and all(
        v["value"] <= v["limit"] for k, v in checks.items()
        if k != "answers_checked")


def _finite(v) -> Any:
    """A number JSON can carry: a non-finite one as its name."""
    return v if math.isfinite(v) else str(v)


def prepare(bench: dict, cell_name: str, seed: int, device,
            build=system.build, root=spec.ROOT, mark=lambda phase: None):
    """A cell's parts, found by name, its weights drawn from the seed, the
    system under test built and its loop's inputs made (not warmed):
    ``cfg``, ``mix``, ``ref``, ``layers``, ``params``, ``loop``. ``mark``
    is called after each phase."""
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    ref = spec.reference(cfg)
    layers = ref.layers(cfg)
    gen = weights.generator(seed, device)
    params = weights.draw(layers, gen, device)
    mark("weights")
    entry = build(cfg, mix, params, device)
    mark("model")
    image = (cfg["hw"], cfg["hw"], cfg["in_ch"])
    loop = spec.loop(mix).Loop(entry, mix, gen, device, seed, image)
    mark("inputs")
    return types.SimpleNamespace(cfg=cfg, mix=mix, ref=ref, layers=layers,
                                 params=params, loop=loop)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             build=system.build, root=spec.ROOT):
    """Run the cell; return the result's fields (the contract's line,
    ``checks`` last) and the run's record. ``t_start`` is the process's
    start on ``time.perf_counter``; ``build`` makes the system under
    test; ``root`` is the checkout whose files name the cell."""
    device = torch.device(device)
    phases = {}

    def mark(phase):
        phases[phase] = time.perf_counter() - t_start
    mark("start")
    made = prepare(bench, cell_name, seed, device, build, root, mark)
    loop = made.loop
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else None
    run = Run(cell=cell_name, batch=made.mix["batch"], layers=made.layers,
              seconds=seconds, device_kind=kind, peak=counts.PEAKS.get(kind))
    loop.warm()
    if on_card:
        if traced:
            trace.warm(device)
        torch.cuda.synchronize(device)
    mark("warm")
    # every run starts its window with the set-up's garbage collected, so
    # whether a full collection falls into the window (a pause of tens of
    # milliseconds in every thread) does not depend on the set-up's history
    gc.collect()
    run.setup_s = time.perf_counter() - t_start
    run.setup_phases = phases

    before = system.launch_counts()
    with GcPauses() as pauses:
        loop.run(run, seconds, traced)
    run.gc = pauses.summary()
    after = system.launch_counts()
    run.launches = {k: v - before[k] for k, v in after.items()
                    if v != before[k]}
    peak_bytes = (torch.cuda.max_memory_allocated(device) if on_card else 0)
    idx, got, missing = loop.answers()
    inputs, ref, params = loop.inputs, made.ref, made.params
    loop.close()
    del loop, made
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    expected = reference_logits(ref, params, inputs)
    checks = compare(idx, got, expected, missing)
    metrics = {}
    for m in spec.metrics(bench, cell_name, traced):
        v = spec.reader(m["name"], root)(run)
        if v is None or not math.isfinite(v):
            print(f"metric {m['name']}: nothing to read ({v})",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type, "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    out = {"correct": passed(checks), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out, run
