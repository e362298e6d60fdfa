"""Per-submit timing, device traces, and the program's spans.

The PyTorch counterpart of ``deepfusion_tpu/utils/profiler.py``. Reference
parity: ``op::submit`` wraps ``infer`` with timing when profiling is on
(``src/deepfusion.cc:90-103``). ``submit_timer`` times a submit on its op's
device: two CUDA events on the device's current stream for a CUDA op (the
only synchronisation, and only when ``DEEPFUSION_PROFILE`` is set), the
host clock for a CPU op. ``device_trace`` records a ``torch.profiler``
trace of every thread and writes it as a Chrome trace.

Spans: ``span(name, **attrs)`` marks a stretch of the program's host work.
There is one switch and no knob of its own: spans record while, and only
while, a ``torch.profiler`` records in the process (``tracing()``), be it
``device_trace`` or any other. Off, a span site costs one flag read: it
reads no clock, takes no lock and builds no record. On, a span opens a
profiler range, which lands in the profiler's trace in its own thread on
the clock of the kernels beside it, and appends a record (``Span``: name,
thread, start and end on ``time.perf_counter_ns``, its id and its parent's)
to a bounded buffer in memory, which ``spans()`` copies and
``clear_spans()`` empties. A span that starts while tracing is on is
recorded whole, even if the profiler stops first. The program's spans:

* ``serving.BatchServer``'s worker, one set per flush: ``serve.flush``
  (attrs ``replica``, ``rows``, ``pad``, ``depth``: the queue left when
  the batch closed; its id is the flush's id) over its children
  ``serve.wait`` (for the first request), ``serve.gather`` (for
  batch-mates), ``serve.stack``, ``serve.h2d``, ``serve.forward``,
  ``serve.d2h`` and ``serve.resolve``; and one ``serve.request`` record per
  request enqueued while tracing (enqueue to resolution, attr ``picked``:
  when the worker took it; its id is the request's, its parent the flush);
* ``models/graphed.py``'s ``GraphedForward``: ``model.replay`` around each
  call and ``model.capture`` (attrs ``shape``, ``dtype``) around a graph's
  capture;
* ``models/resnet50.py``'s and ``models/googlenet.py``'s forwards:
  ``model.layer`` (attrs ``name``, ``kind``; a GoogLeNet concat also
  ``inputs`` and ``lanes``) around each layer, in an eager forward or a
  graph's capture.

The JAX package's ``maybe_dump_lowered`` (lowered XLA text) is not ported:
``DEEPFUSION_DUMP_CODE`` keeps ptxas's report of the kernel build instead
(``_build.py``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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
    try:    # the host's ops and spans in every thread, a server's worker too
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:       # an older PyTorch: the starting thread only
        cfg = None
    with profile(activities=acts, experimental_config=cfg) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    info("device trace written to %s", path)


# ------------------------------------------------------------------- spans

BUFFER_LEN = 2 ** 18     # records kept; the oldest go first


class Span(NamedTuple):
    """One record of the span buffer: times on ``time.perf_counter_ns``,
    ``tid`` from ``threading.get_ident``, ``parent`` the id of the span
    open around it in its thread (None at the top)."""
    name: str
    tid: int
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    attrs: dict


# the profiler range a span opens: the cheap C++ one where this PyTorch has it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function
_IDS = itertools.count(1)
# plain tuples in Span's field order, attrs as a tuple of items: a record
# of strings, numbers and tuples alone, which the garbage collector stops
# tracking (a dict in it would keep it tracked, and a buffer of tracked
# records brings on full collections, each a pause of every thread); a
# deque's append, clear and copy are each one C call, which no other
# thread interleaves under the interpreter lock
_BUFFER: collections.deque = collections.deque(maxlen=BUFFER_LEN)
_OPEN = threading.local()   # .id: this thread's innermost open span
_get_ident = threading.get_ident
now_ns = time.perf_counter_ns


def tracing() -> bool:
    """Whether a ``torch.profiler`` records in this process: the one switch
    of the spans."""
    return _autograd_profiler._is_profiler_enabled


def new_id() -> int:
    """An id no span or record of this process has."""
    return next(_IDS)


def record(name: str, start_ns: int, end_ns: int, id: int,
           parent: Optional[int] = None, **attrs) -> None:
    """Append a finished record that no profiler range marks (such as a
    request's, whose ends lie in different threads)."""
    _BUFFER.append((name, _get_ident(), start_ns, end_ns, id, parent,
                    tuple(attrs.items())))


def spans() -> list:
    """A copy of the span buffer (``Span`` records), oldest first."""
    return [Span(*r[:6], dict(r[6])) for r in _BUFFER.copy()]


def clear_spans() -> None:
    _BUFFER.clear()


class _Off:
    """The span of every site while tracing is off: false, with no id.
    Its ``__enter__`` and ``__exit__`` are set below to C callables, so a
    ``with`` over it runs no Python frame (which would double a site's
    cost): ``__enter__`` returns the object itself, ``__exit__`` returns
    ``""``, which is false, so an exception goes on."""
    __slots__ = ()
    id = None

    def __bool__(self):
        return False

    def discard(self):
        pass


_OFF = _Off()
_Off.__enter__ = itertools.repeat(_OFF).__next__
_Off.__exit__ = "".format


class _Span:
    """An open span: a profiler range and, at its end, a record. ``attrs``
    may grow until it ends; ``discard()`` keeps its record out of the
    buffer (the profiler's range stays in the trace)."""
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_range",
                 "_keep")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.id = name, attrs, next(_IDS)
        self._keep = True

    def __enter__(self):
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.parent = getattr(_OPEN, "id", None)
        _OPEN.id = self.id
        self.start_ns = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = now_ns()
        _OPEN.id = self.parent
        if self._keep:
            _BUFFER.append((self.name, _get_ident(), self.start_ns, end,
                            self.id, self.parent, tuple(self.attrs.items())))
        self._range.__exit__(exc_type, exc, tb)

    def discard(self):
        self._keep = False


def span(name: str, /, **attrs):
    """A context manager over a stretch of host work, recorded as the
    module says while ``tracing()``; otherwise a false no-op whose ``id``
    is None. Compute costly attrs only under ``if s:``. An attr may be
    called ``name`` too (``model.layer``'s)."""
    if not tracing():
        return _OFF
    return _Span(name, attrs)
