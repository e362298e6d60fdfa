"""Closed loop: ``clients`` callers, each with one single-image request in
flight. Each client is a thread of the harness: it submits, waits for its
result, and submits the next, until the window (and a traced stretch)
has passed. ``completed`` counts the results that came within the
window. Each client walks its own part of one seeded sequence of pool
images."""
from __future__ import annotations

import sys
import threading
import time
import traceback

from ..trace import Tracer
from .served import WAIT_S, Served

TICK_S = 0.005
SEQUENCE = 1 << 16


class Loop(Served):
    def run(self, run, seconds: float, traced: bool) -> None:
        clients = int(self.mix["clients"])
        seq = self.rng.integers(0, len(self.pool), SEQUENCE)
        sending = threading.Event()
        sending.set()
        records = [[] for _ in range(clients)]   # (pool index, out, t)
        errors = [0] * clients
        start = threading.Barrier(clients + 1)

        def client(c):
            start.wait()
            k = c
            while sending.is_set():
                i = seq[k % SEQUENCE]
                k += clients
                try:
                    out = self.server.submit(self.pool[i]).result(
                        timeout=WAIT_S)
                except Exception:   # a failed request; the client goes on
                    traceback.print_exc(file=sys.stderr)
                    errors[c] += 1
                    continue
                records[c].append((i, out, time.perf_counter()))

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"portbench-client-{c}")
                   for c in range(clients)]
        flushes0 = self.stats()["flushes"]
        for t in threads:
            t.start()
        end = time.perf_counter() + seconds
        start.wait()
        tracer = Tracer(traced, end)
        stats0 = self.stats()
        time.sleep(max(0.0, end - time.perf_counter()))
        s = self.stats()
        run.server_delta = {k: s[k] - stats0[k] for k in s}
        while not tracer.done:
            tracer.tick(time.perf_counter())
            time.sleep(TICK_S)
        sending.clear()
        for t in threads:
            t.join()
        run.calls = self.stats()["flushes"] - flushes0
        run.trace = tracer.summary()
        run.completed = sum(1 for r in records for _, _, t in r if t <= end)
        self.answered = [(i, o) for r in records for i, o, _ in r]
        self.missing = sum(errors)
        run.failed = self.missing
        run.attempted = len(self.answered) + self.missing
