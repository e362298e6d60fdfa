"""The program's own span records, for the readers of ``program_span``
metrics.

``deepfusion_tpu_torch.utils.profiler`` keeps a record of every span that
began while a ``torch.profiler`` recorded in the process, and keeps it
whole: a span open when the profiler stops ends later, stretched by the
profiler's own work in stopping (the interpreter lock), and a request
queued then waits for it. So a reader takes the records that ended within
the traced stretch: from the first record's start, the stretch's length
(``window_s``, between the trace's markers). One run of ``run.py`` runs
one cell, so the buffer holds that run's spans alone (the set-up's
``trace.warm`` runs no flush and no forward). A program without span
records, or a run without a trace, gives none, and a reader then reads
nothing.
"""
from __future__ import annotations

from collections import defaultdict


def records(run, name: str) -> list:
    """The program's records called `name` that ended within the run's
    traced stretch, oldest first."""
    from deepfusion_tpu_torch.utils import profiler
    spans = getattr(profiler, "spans", None)
    if spans is None or run.trace is None:
        return []
    recs = spans()
    if not recs:
        return []
    end = min(r.start_ns for r in recs) + run.trace["window_s"] * 1e9
    return [r for r in recs if r.name == name and r.end_ns <= end]


def mean(values):
    return sum(values) / len(values) if values else None


def flush_host_ns(run) -> list:
    """Per flush recorded with its ``serve.wait`` and ``serve.gather``
    children: its length less theirs, in ns (the worker's own work)."""
    waits = defaultdict(int)
    seen = defaultdict(set)
    for name in ("serve.wait", "serve.gather"):
        for r in records(run, name):
            waits[r.parent] += r.end_ns - r.start_ns
            seen[r.parent].add(name)
    return [f.end_ns - f.start_ns - waits[f.id]
            for f in records(run, "serve.flush") if len(seen[f.id]) == 2]
