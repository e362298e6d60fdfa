"""The port's spans (``deepfusion_tpu_torch/utils/profiler.py``) on the CPU.

Spans record while, and only while, a ``torch.profiler`` records: off, a
span opens no profiler range and appends nothing. On, ``BatchServer``'s
worker records one ``serve.flush`` per flush over its seven children in
order, one ``serve.request`` per request, and ``GraphedForward`` one
``model.replay`` per call (its CPU path: the forward itself); a trace
written by ``device_trace`` holds the worker's spans in the worker's
thread.
"""
import gc
import json
import threading

import numpy as np
import pytest
import torch

from deepfusion_tpu_torch import models
from deepfusion_tpu_torch.serving import BatchServer
from deepfusion_tpu_torch.utils import profiler
from deepfusion_tpu_torch.utils.profiler import device_trace, span

torch.set_num_threads(2)

FLUSH_CHILDREN = ["serve.wait", "serve.gather", "serve.stack", "serve.h2d",
                  "serve.forward", "serve.d2h", "serve.resolve"]
SIZE = dict(batch=2, hw=8, in_ch=16, width=32, num_classes=16)


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def fwd():
    net = models.FusionNet(models.FusionNetConfig(**SIZE), device="cpu")
    return net.jit()


@pytest.fixture(autouse=True)
def empty_buffer():
    profiler.clear_spans()
    yield
    profiler.clear_spans()


def _serve(fwd, n: int):
    """`n` requests through a BatchServer of batch 2 over `fwd`, started
    and closed inside a CPU profile; the server's stats and its worker's
    thread id."""
    xs = [np.full(fwd.input_shape[1:], i, np.uint8) for i in range(n)]
    with _cpu_profile():
        with BatchServer(fwd, batch=2, input_shape=xs[0].shape) as srv:
            for f in srv.submit_many(xs):
                f.result(timeout=60)
            tid = srv._workers[0].ident
    return srv.stats, tid


def test_off_span_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a span opened a profiler range while off")
    monkeypatch.setattr(profiler, "_RANGE", no_range)
    assert not profiler.tracing()
    with span("serve.flush", replica=0) as s:
        with span("serve.wait") as child:
            child.discard()
    assert not s and s.id is None
    assert profiler.spans() == []


def test_tracing_follows_the_profilers_enter_and_exit(tmp_path):
    assert not profiler.tracing()
    with _cpu_profile():
        assert profiler.tracing()
    assert not profiler.tracing()
    with device_trace(str(tmp_path)):
        assert profiler.tracing()
    assert not profiler.tracing()


def test_spans_nest_carry_attrs_and_are_recorded_whole():
    """Parent ids follow the nesting in a thread; attrs may grow until the
    end; a span begun while tracing ends after the profiler stopped and is
    kept; one begun after it stopped is not; a discarded one is not."""
    prof = _cpu_profile()
    prof.__enter__()
    with span("outer", a=1) as outer:
        with span("inner") as inner:
            pass
        outer.attrs["b"] = 2
        with span("dropped") as dropped:
            dropped.discard()
        prof.__exit__(None, None, None)
        with span("late"):
            pass
    recs = {r.name: r for r in profiler.spans()}
    assert set(recs) == {"outer", "inner"}
    assert recs["inner"].parent == outer.id == recs["outer"].id
    assert recs["outer"].parent is None and recs["outer"].attrs == dict(
        a=1, b=2)
    assert inner.id == recs["inner"].id
    o, i = recs["outer"], recs["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert o.tid == i.tid == threading.get_ident()


def test_batch_server_records_one_flush_per_flush_over_its_children(fwd):
    stats, tid = _serve(fwd, 7)
    recs = [r for r in profiler.spans() if r.tid == tid]
    flushes = [r for r in recs if r.name == "serve.flush"]
    assert len(flushes) == stats["flushes"] >= 4
    assert sum(f.attrs["rows"] for f in flushes) == 7
    for f in flushes:
        assert f.attrs["replica"] == 0 and f.attrs["depth"] >= 0
        assert f.attrs["pad"] == 2 - f.attrs["rows"]
        kids = sorted((r for r in recs if r.parent == f.id
                       and r.name.startswith("serve.")
                       and r.name != "serve.request"),
                      key=lambda r: r.start_ns)
        assert [k.name for k in kids] == FLUSH_CHILDREN
        t = f.start_ns
        for k in kids:
            assert t <= k.start_ns <= k.end_ns
            t = k.end_ns
        assert t <= f.end_ns
        forward = kids[FLUSH_CHILDREN.index("serve.forward")]
        replays = [r for r in recs if r.parent == forward.id]
        assert [r.name for r in replays] == ["model.replay"]


def test_request_records_are_ordered_and_name_their_flush(fwd):
    stats, tid = _serve(fwd, 5)
    recs = profiler.spans()
    flush_ids = {r.id for r in recs if r.name == "serve.flush"}
    reqs = [r for r in recs if r.name == "serve.request"]
    assert len(reqs) == stats["requests"] == 5
    assert len({r.id for r in reqs}) == 5
    for r in reqs:
        assert r.start_ns <= r.attrs["picked"] <= r.end_ns
        assert r.parent in flush_ids and r.tid == tid


def test_model_replay_is_recorded_once_per_call(fwd):
    x = torch.zeros(fwd.input_shape, dtype=torch.uint8)
    fwd(x)                          # untraced: no record
    with _cpu_profile():
        for _ in range(3):
            fwd(x)
    recs = profiler.spans()
    assert [r.name for r in recs] == ["model.replay"] * 3
    assert all(r.parent is None and r.end_ns >= r.start_ns for r in recs)


def test_the_buffer_drops_its_oldest_records_at_maxlen():
    n = profiler.BUFFER_LEN + 3
    for i in range(n):
        profiler.record("r", i, i, i)
    recs = profiler.spans()
    assert len(recs) == profiler.BUFFER_LEN
    assert recs[0].id == 3 and recs[-1].id == n - 1


def test_records_leave_the_garbage_collectors_care():
    """A record holds strings, numbers and tuples alone (attrs as items),
    so collections stop tracking it, a level each (the items, their tuple,
    the record), before it grows old: a buffer of tracked records would
    bring on full collections, each pausing every thread."""
    with _cpu_profile():
        with span("serve.flush", replica=0) as s:
            s.attrs.update(rows=8, shape=(8, 3))
        profiler.record("serve.request", 1, 2, profiler.new_id(), s.id,
                        picked=1)
    for _ in range(3):
        gc.collect()
    assert len(profiler._BUFFER) == 2
    assert not any(gc.is_tracked(r) for r in profiler._BUFFER)
    flush, req = profiler.spans()
    assert flush.attrs == dict(replica=0, rows=8, shape=(8, 3))
    assert req.attrs == dict(picked=1) and req.parent == flush.id


def test_device_trace_holds_the_workers_spans_in_its_thread(fwd, tmp_path):
    """The worker starts before the profiler, as a deployed server's does,
    and its spans still land in the trace under its own thread."""
    shape = fwd.input_shape[1:]
    with BatchServer(fwd, batch=2, input_shape=shape) as srv:
        srv.submit(np.zeros(shape, np.uint8)).result(timeout=60)
        with device_trace(str(tmp_path)):
            for _ in range(3):
                futs = [srv.submit(np.zeros(shape, np.uint8))
                        for _ in range(2)]
                for f in futs:
                    f.result(timeout=60)
        worker = srv._workers[0].native_id
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids = {e.get("tid") for e in events if e.get("name") == "serve.flush"}
    assert tids == {worker}
    names = {e.get("name") for e in events if e.get("tid") == worker}
    assert set(FLUSH_CHILDREN) <= names and "model.replay" in names
