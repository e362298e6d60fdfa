"""Host-side continuous batching for inference serving.

The PyTorch counterpart of ``deepfusion_tpu/serving.py``: requests
accumulate in a host queue and a worker thread per replica flushes them
through a fixed-batch model; short tails are padded and the padding rows
dropped. ``submit`` feeds the least loaded replica, ``submit_many`` splits a
burst across replicas with ``balance211``.

The worker turns the stacked numpy batch into a u8 tensor on the model's
device, runs the model under ``torch.inference_mode()`` (which is
thread-local, so the worker enters it itself) and copies the result back to
a numpy array. The device is the model's ``device`` attribute (such as
``FusionNet.device``, or a ``parallel`` wrapper's first slot, as for a
``dp_shard``-split model) or, for a bound method, its object's; a model
with neither is refused, so no batch lands on the CPU by default.

While a ``torch.profiler`` records (``utils/profiler.py``: ``device_trace``
writes a file), each flush records the spans ``serve.flush`` (from the wait
for its first request to its last result) over ``serve.wait``,
``serve.gather``, ``serve.stack``, ``serve.h2d``, ``serve.forward``,
``serve.d2h`` and ``serve.resolve``, in the worker's thread, and every
request enqueued meanwhile a ``serve.request`` record (enqueued, picked up,
resolved; its flush as parent). Off, each site costs one flag read.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Sequence, Union

import numpy as np
import torch

from .utils import profiler
from .utils.logger import CheckError, check, info
from .utils.mathutil import balance211
from .utils.profiler import span


def model_device(fn) -> torch.device:
    """The device a served callable runs on: its ``device`` attribute, or
    its object's for a bound method."""
    for obj in (fn, getattr(fn, "__self__", None)):
        dev = getattr(obj, "device", None)
        if dev is not None:
            return torch.device(dev)
    raise CheckError(
        f"{fn!r} names no device: serve a module with a `device` "
        "attribute (such as FusionNet.packed_module() or a dp_shard-split "
        "model) or a bound method of one")


class BatchServer:
    """Continuous batcher over fixed-batch model callable(s).

    model_fn: one callable, or a sequence of them (one per replica), taking
        a (batch, ...) u8 tensor and returning a (batch, ...) tensor
    batch: the batch size the model runs (requests are padded up to it)
    max_delay_ms: max time a request waits for batch-mates before a
        partial (padded) flush
    """

    def __init__(self, model_fn: Union[Callable, Sequence[Callable]],
                 batch: int, input_shape,
                 max_delay_ms: float = 2.0, input_dtype=np.uint8):
        check(batch >= 1, "batch must be >= 1")
        self._fns = list(model_fn) if isinstance(model_fn, (list, tuple)) \
            else [model_fn]
        check(len(self._fns) >= 1, "need at least one model replica")
        self._devices = [model_device(fn) for fn in self._fns]
        self._batch = batch
        self._in_shape = tuple(input_shape)
        self._in_dtype = np.dtype(input_dtype)
        self._delay = max_delay_ms / 1e3
        self._qs = [queue.Queue() for _ in self._fns]
        self._stop = threading.Event()
        self._workers = [
            threading.Thread(target=self._run, args=(r,), daemon=True)
            for r in range(len(self._fns))]
        self._started = False
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "flushes": 0, "padded_rows": 0,
                      "per_replica": [0] * len(self._fns)}

    @property
    def n_replicas(self) -> int:
        return len(self._fns)

    # ------------------------------------------------------------- API

    def start(self):
        if not self._started:
            for w in self._workers:
                w.start()
            self._started = True
        return self

    def _enqueue(self, x: np.ndarray, replica: int) -> Future:
        x = np.asarray(x, dtype=self._in_dtype)
        check(tuple(x.shape) == self._in_shape,
              f"request shape {x.shape} != {self._in_shape}")
        fut: Future = Future()
        # while tracing: [request id, enqueued], to which pick-up is added
        stamp = [profiler.new_id(), profiler.now_ns()] \
            if profiler.tracing() else None
        self._qs[replica].put((x, fut, stamp))
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["per_replica"][replica] += 1
        return fut

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one request (shape == input_shape) on the least-loaded
        replica."""
        replica = min(range(len(self._qs)),
                      key=lambda r: self._qs[r].qsize())
        return self._enqueue(x, replica)

    def submit_many(self, xs: Sequence[np.ndarray]):
        """Enqueue a burst, split near-equally across replicas with
        balance211 (replica r gets the contiguous [start, end) slice)."""
        futs: list = [None] * len(xs)
        for r in range(len(self._fns)):
            start, end = balance211(len(xs), len(self._fns), r)
            for i in range(start, end):
                futs[i] = self._enqueue(xs[i], r)
        return futs

    def close(self):
        self._stop.set()
        if self._started:
            for w in self._workers:
                w.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- worker

    @staticmethod
    def _take(q, timeout: float):
        item = q.get(timeout=timeout)
        if item[2] is not None:
            item[2].append(profiler.now_ns())
        return item

    def _gather(self, q):
        """Collect up to `batch` requests: wait for the first (looking for
        a stop every 50 ms; empty only once the server stops), then at most
        max_delay for each straggler."""
        items = []
        with span("serve.wait"):
            while not items:
                try:
                    items.append(self._take(q, 0.05))
                except queue.Empty:
                    if self._stop.is_set():
                        return items
        with span("serve.gather"):
            while len(items) < self._batch:
                try:
                    items.append(self._take(q, self._delay))
                except queue.Empty:
                    break
        return items

    def _run(self, replica: int):
        fn, q = self._fns[replica], self._qs[replica]
        device = self._devices[replica]
        with torch.inference_mode():
            while not self._stop.is_set() or not q.empty():
                with span("serve.flush", replica=replica) as flush:
                    items = self._gather(q)
                    if not items:       # stopped with nothing queued
                        flush.discard()
                        continue
                    if flush:
                        flush.attrs.update(rows=len(items),
                                           pad=self._batch - len(items),
                                           depth=q.qsize())
                    self._flush(fn, device, items, flush.id)
        if replica == 0:
            info("batch server drained: %s", self.stats)

    def _flush(self, fn, device, items: list, flush_id):
        with span("serve.stack"):
            xs = np.stack([x for x, _, _ in items])
            pad = self._batch - len(items)
            if pad:
                xs = np.concatenate(
                    [xs, np.zeros((pad,) + self._in_shape, self._in_dtype)])
        try:
            with span("serve.h2d"):
                x = torch.from_numpy(xs).to(device)
            with span("serve.forward"):
                y = fn(x)
            with span("serve.d2h"):
                out = y.cpu().numpy()
        except Exception as e:  # propagate to all waiters
            for _, fut, _ in items:
                fut.set_exception(e)
            return
        with span("serve.resolve"):
            with self._stats_lock:
                self.stats["flushes"] += 1
                self.stats["padded_rows"] += pad
            for i, (_, fut, stamp) in enumerate(items):
                fut.set_result(out[i])
                if stamp is not None:
                    profiler.record("serve.request", stamp[1],
                                    profiler.now_ns(), stamp[0], flush_id,
                                    picked=stamp[2])
