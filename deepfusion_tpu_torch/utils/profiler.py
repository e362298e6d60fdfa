"""Per-submit timing and device traces.

The PyTorch counterpart of ``deepfusion_tpu/utils/profiler.py``. Reference
parity: ``op::submit`` wraps ``infer`` with timing when profiling is on
(``src/deepfusion.cc:90-103``). ``submit_timer`` times a submit on its op's
device: two CUDA events on the device's current stream for a CUDA op (the
only synchronisation, and only when ``DEEPFUSION_PROFILE`` is set), the
host clock for a CPU op. ``device_trace`` records a ``torch.profiler``
trace and writes it as a Chrome trace.

The JAX package's ``maybe_dump_lowered`` (lowered XLA text) is not ported:
``DEEPFUSION_DUMP_CODE`` keeps ptxas's report of the kernel build instead
(``_build.py``).
"""
from __future__ import annotations

import contextlib
import os

import torch

from . import env
from .logger import get_current_ms, info


@contextlib.contextmanager
def submit_timer(name: str, device=None):
    """Log ``"<name> infer <ms> ms"`` for the block when profiling is on
    (reference: ``src/deepfusion.cc:91-102``); a CUDA ``device`` is timed
    with CUDA events, anything else with the host clock. Off, it adds
    nothing and never synchronises."""
    if not env.is_profiling():
        yield
        return
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type != "cuda":
        t0 = get_current_ms()
        yield
        info("%s infer %f ms", name, get_current_ms() - t0)
        return
    stream = torch.cuda.current_stream(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    end.synchronize()
    info("%s infer %f ms", name, start.elapsed_time(end))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block, with the cards'
    activity where CUDA is present (the host's alone where it is not), and
    write it to ``<log_dir>/trace.json`` (Chrome trace format). Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    info("device trace written to %s", path)
