"""The models' compiled callables: a forward captured in a CUDA graph.

The PyTorch counterpart of the JAX package's ``jax.jit(net.__call__)`` and
``jax.jit(net.packed_call)`` (``FusionNet.jit``/``jit_packed`` and those of
ResFusionNet and VGGFusion). ``jax.jit`` traces a forward once per input
shape and replays the compiled program; ``GraphedForward`` captures the
forward in a CUDA graph once per input shape and dtype and replays it, so a
call skips the wrappers' host work (checks, allocations, the ops' launch
paths).

A first call at a shape, on the card: a static input on the model's device
takes the caller's input; the forward runs twice on a side stream (this
opens the kernel library, encodes the weights' tensor maps and fills the
ops' config caches, none of which may happen inside a capture); then one
forward is captured into the graph's private memory pool. Every call copies
the input into the static input, replays the graph on the current stream
and returns a clone of the static output: a result never changes under a
later call, as a JAX array does not. The activations' tensor maps are
kernel parameters baked into the graph, and so are the weights' addresses;
they stay right while the static input, the pool and the weights stay put,
and the callable raises once the model has been moved since the capture.

On the CPU it calls the forward under ``torch.inference_mode()`` and makes
no graph. A failed capture raises; nothing runs the eager forward in its
place.

Launch counts (``_build.count_launch``) run in Python, so under a graph
they would run once, at capture, when the card runs nothing: the capture's
counts are taken out (``counted``) and put back at every replay, and the
counts keep saying what ran on the card.

While a ``torch.profiler`` records (``utils/profiler.py``), every call
records a ``model.replay`` span (the host's part of a call: the lock, the
capture lookup, the input copy's and the replay's enqueue, the output's
clone; on the CPU the forward itself) and every capture a
``model.capture`` span with the input's ``shape`` and ``dtype``, so a
graph built again mid-run shows in a trace. Off, each costs one flag read.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from .. import _build
from ..utils.logger import check
from ..utils.profiler import span

WARMUP = 2   # eager forwards on a side stream before a capture
_MOVED = ("the model's weights moved since its graph was captured: call "
          "jit() again")

_locks_lock = threading.Lock()
_capture_locks: dict = {}   # torch.device -> the lock its captures take


def _capture_lock(device: torch.device) -> threading.Lock:
    """The one lock that serializes the captures on `device`."""
    with _locks_lock:
        return _capture_locks.setdefault(device, threading.Lock())


def counted(fn, *args):
    """``fn(*args)`` and the launch counts it added, which are taken back
    out of the counts: ``_build.add_counts(delta)`` puts them back."""
    before = _build.snapshot_counts()
    out = fn(*args)
    after = _build.snapshot_counts()
    delta = {k: v - before[k] for k, v in after.items() if v != before[k]}
    _build.add_counts(delta, -1)
    return out, delta


@dataclasses.dataclass
class _Capture:
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    delta: dict      # the launch counts of one forward
    # the model's first buffer at capture: moving the model (.to(), .cpu(),
    # .cuda()) replaces it, and holding it keeps its old memory from being
    # handed back to the moved copy at the same address
    anchor: torch.Tensor


class GraphedForward:
    """A model's bound forward (``net.forward``, ``net.packed_call``) as a
    compiled callable: on the card one CUDA graph per input shape and
    dtype, replayed per call; on the CPU the forward itself. Carries the
    model's ``device`` and ``input_shape``, so ``BatchServer`` serves it.
    Calls from several threads are serialized (they share the static
    input and output)."""

    def __init__(self, fn):
        self._fn = fn
        self._net = fn.__self__
        self._captures: dict = {}
        self._lock = threading.Lock()
        # where the model's first buffer lives, looked up once: a call
        # reads it with one getattr, not a walk over the modules
        name, _ = next(self._net.named_buffers())
        prefix, _, self._leaf = name.rpartition(".")
        self._owner = self._net.get_submodule(prefix)

    def _first_buffer(self) -> torch.Tensor:
        return getattr(self._owner, self._leaf)

    @property
    def device(self) -> torch.device:
        return self._net.device

    @property
    def input_shape(self):
        return self._net.input_shape

    @property
    def captures(self) -> int:
        """The graphs captured so far: one per input shape and dtype."""
        return len(self._captures)

    def __call__(self, x) -> torch.Tensor:
        with span("model.replay"):
            if self.device.type == "cpu":
                check(not self._captures, _MOVED)
                with torch.inference_mode():
                    return self._fn(x)
            x = torch.as_tensor(x)
            with self._lock:
                cap = self._captures.get((tuple(x.shape), x.dtype))
                if cap is None:
                    cap = self._capture(x)
                check(self._first_buffer() is cap.anchor, _MOVED)
                with torch.inference_mode():
                    cap.static_in.copy_(x)
                    cap.graph.replay()
                _build.add_counts(cap.delta)
                return cap.static_out.clone()

    def _capture(self, x: torch.Tensor) -> _Capture:
        dev = self.device
        with span("model.capture", shape=tuple(x.shape),
                  dtype=str(x.dtype)), _capture_lock(dev), \
                torch.cuda.device(dev), torch.inference_mode():
            static_in = torch.empty(x.shape, dtype=x.dtype, device=dev)
            static_in.copy_(x)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    self._fn(static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out, delta = counted(self._fn, static_in)
        cap = _Capture(graph, static_in, static_out, delta,
                       self._first_buffer())
        self._captures[(tuple(x.shape), x.dtype)] = cap
        return cap
