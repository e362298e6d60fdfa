"""The device trace of a run: torch.profiler over a stretch of the loop.

A traced run goes on past its measured window for ``TRACE_S`` seconds with
the profiler on (CPU and CUDA activity), so the window's own numbers are
taken with no profiler running. The stretch is marked by two
``record_function`` markers; its chrome trace is written under the
temporary directory, read, and deleted. ``summarize`` reduces it to the
device's busy time (the union of kernel, copy and fill intervals), the
kernel time, the device operations that took the most time, and the idle
gaps named by the innermost host operation running at each gap's middle.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

TRACE_S = 3.0
TOP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
START, END = "portbench.trace_start", "portbench.trace_end"
NO_HOST_OP = "no host op"


def _profiler():
    """CPU and CUDA activity, the host's ops in every thread (the served
    loops' work runs in the batcher's and the clients' threads) where this
    PyTorch can record them."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:       # an older PyTorch: the starting thread only
        cfg = None
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA],
        experimental_config=cfg)


def warm(device) -> None:
    """A first, short profile: the profiler's first start in a process
    takes seconds, which a traced run pays in its set-up."""
    with _profiler():
        (torch.ones(1, device=device) + 1).cpu()


class Tracer:
    """Starts the profiler once ``tick`` sees ``start_at``
    (``time.perf_counter()`` seconds) pass, and stops it ``length``
    seconds after it has started (starting it can take seconds); ``tick``
    is called from one thread, which also reads the result. ``units``
    counts what the loop completed in between (the forwards of an offline
    loop). Disabled, it is ``done`` from the start."""

    def __init__(self, enabled: bool, start_at: float,
                 length: float = TRACE_S):
        self.start_at, self.length = start_at, length
        self.stop_at = None
        self._prof = None
        self._units0 = self.units = None
        self.done = not enabled

    def tick(self, now: float, units: int = 0) -> None:
        if self.done:
            return
        if self._prof is None and now >= self.start_at:
            self._prof = _profiler()
            self._prof.__enter__()
            with torch.profiler.record_function(START):
                pass
            self._units0 = units
            self.stop_at = time.perf_counter() + self.length
        elif self._prof is not None and now >= self.stop_at:
            with torch.profiler.record_function(END):
                pass
            self._prof.__exit__(None, None, None)
            self.units = units - self._units0
            self.done = True

    def summary(self):
        """The trace's summary (``summarize``), or None untraced."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_names(host, points):
    """For each of `points` (sorted), the name of the shortest host event
    running at it, or ``NO_HOST_OP``: a sweep with a heap of the events
    begun, by their ends."""
    host = sorted(host)
    names, active, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            heapq.heappush(active, (host[i][1], host[i][1] - host[i][0],
                                    host[i][2]))
            i += 1
        while active and active[0][0] <= p:
            heapq.heappop(active)
        names.append(min(active, key=lambda a: a[1])[2] if active
                     else NO_HOST_OP)
    return names


def summarize(events: list):
    """Reduce chrome-trace events (times in us) to seconds: ``window_s``
    between the markers, ``busy_s`` (the union of device intervals inside
    it), ``kernel_s`` (the sum of kernel durations inside it),
    ``device_ops`` and ``idle_gaps`` (top [name, seconds] pairs: device
    time by operation name, idle time by what the host was running).
    None where the markers are missing."""
    marks = {e["name"]: e["ts"] for e in events
             if e.get("name") in (START, END)
             and e.get("cat") != "gpu_user_annotation"}
    if START not in marks or END not in marks:
        return None
    t0, t1 = marks[START], marks[END]
    dev, host = [], []
    ops = defaultdict(float)
    kernel_us = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s, end = max(s, t0), min(s + d, t1)
            if end <= s:
                continue
            dev.append((s, end))
            ops[e["name"]] += end - s
            if e["cat"] == "kernel":
                kernel_us += end - s
        elif e.get("cat") in HOST_CATS and e["name"] not in (START, END):
            host.append((s, s + d, e["name"]))
    busy = _union(dev)
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(float)
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _host_names(host, mids)):
        idle[name] += b - a

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(window_s=(t1 - t0) / 1e6,
                busy_s=sum(e - s for s, e in busy) / 1e6,
                kernel_s=kernel_us / 1e6,
                device_ops=top(ops), idle_gaps=top(idle))
