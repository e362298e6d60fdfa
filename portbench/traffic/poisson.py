"""Open loop: single-image requests at Poisson arrivals of a fixed rate.

One sender thread submits each request when it is due, whatever is still
outstanding. Every seed gets the same number of requests in the window and
the same set of gaps between arrivals (the exponential distribution's
quantiles at ``rate_per_s``, scaled to fill the window), in an order the
seed draws; so the seed changes the order, not the work. A traced run
repeats the window's arrivals after it until the traced stretch is over.

A request's latency runs from when it was due to when its result is set:
a callback on its future stamps the time and keeps the result, so the
harness holds no future (a heap of them would slow the interpreter's
garbage collection, and with it every thread). ``late_s`` is how late the
sender sent each request. A request never answered has an infinite
latency.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..trace import Tracer
from .served import WAIT_S, Served

TICK_S = 0.005


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival offsets (seconds, ascending, the first at 0) of
    ``round(rate * seconds)`` requests over ``seconds``."""
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(seed).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Loop(Served):
    def run(self, run, seconds: float, traced: bool) -> None:
        rate = float(self.mix["rate_per_s"])
        offsets = schedule(rate, seconds, self.rng.integers(2 ** 63))
        n = len(offsets)
        which = self.rng.integers(0, len(self.pool), n)
        cap = 4 * n if traced else n     # room for the traced stretch
        sent = np.full(cap, np.nan)
        done = np.full(cap, np.nan)
        rows = [None] * cap
        sending = threading.Event()
        sending.set()
        t0 = time.perf_counter() + 0.01
        end = t0 + seconds

        def finished(i, fut):
            if fut.exception() is None:
                rows[i] = fut.result()
            done[i] = time.perf_counter()

        def send():
            for i in range(cap):
                if i >= n and not sending.is_set():
                    break
                due = t0 + seconds * (i // n) + offsets[i % n]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[i] = time.perf_counter()
                f = self.server.submit(self.pool[which[i % n]])
                f.add_done_callback(lambda fut, i=i: finished(i, fut))

        flushes0 = self.stats()["flushes"]
        sender = threading.Thread(target=send, name="portbench-sender")
        sender.start()
        tracer = Tracer(traced, end)
        time.sleep(max(0.0, t0 - time.perf_counter()))
        stats0 = self.stats()
        time.sleep(max(0.0, end - time.perf_counter()))
        s = self.stats()
        run.server_delta = {k: s[k] - stats0[k] for k in s}
        while not tracer.done:
            tracer.tick(time.perf_counter())
            time.sleep(TICK_S)
        sending.clear()
        sender.join()
        m = int(np.sum(~np.isnan(sent)))
        deadline = time.perf_counter() + WAIT_S
        while np.isnan(done[:m]).any() and time.perf_counter() < deadline:
            time.sleep(TICK_S)
        run.calls = self.stats()["flushes"] - flushes0
        run.trace = tracer.summary()
        for i in range(m):
            if rows[i] is None:
                self.missing += 1
            else:
                self.answered.append((which[i % n], rows[i]))
        run.failed = self.missing
        due = t0 + offsets
        lat = done[:n] - due
        lat[np.isnan(lat) | np.array([r is None for r in rows[:n]])] = np.inf
        run.latencies_s = lat
        run.late_s = sent[:n] - due
        run.completed = int(np.sum(done[:n] <= end))
        run.attempted = m
