"""Offline scoring: a closed loop of whole batches, one in flight.

Each call takes the next batch from a ring of ``ring`` distinct u8 batches
made on the device (so the input is read from device memory, as after a
decode stage there) and brings its logits to the host. ``images`` counts
the images whose logits reached the host within the window. The first
call and one in ``KEEP`` (from an offset the seed picks) keep their logits
for the check.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..trace import Tracer

KEEP = 8


class Loop:
    def __init__(self, entry, mix: dict, gen, device, seed: int,
                 image_shape):
        self.entry = entry
        self.batch, self.n_ring = mix["batch"], mix["ring"]
        self.inputs = weights.images(
            gen, (self.n_ring * self.batch,) + tuple(image_shape), device)
        self.ring = self.inputs.view(self.n_ring, self.batch,
                                     *image_shape)
        self.keep_at = seed % KEEP
        self.kept = {}
        self.on_card = torch.device(device).type == "cuda"

    def warm(self) -> None:
        """The first call captures the forward at the batch's shape."""
        for x in self.ring:
            self.entry(x).cpu()

    def run(self, run, seconds: float, traced: bool) -> None:
        timed = traced and self.on_card
        events = []
        t0 = time.perf_counter()
        end = t0 + seconds
        tracer = Tracer(traced, end)
        i = images = 0
        now = t0
        while now < end or not tracer.done:
            tracer.tick(now, i)
            x = self.ring[i % self.n_ring]
            if timed and now < end:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = self.entry(x)
                ev[1].record()
                events.append(ev)
            else:
                out = self.entry(x)
            logits = out.cpu()
            now = time.perf_counter()
            if now <= end:
                images += self.batch
            if i % KEEP == self.keep_at or i == 0:
                self.kept[i] = logits.numpy()
            i += 1
        run.images = images
        run.calls = i
        run.attempted = i * self.batch
        if timed:
            run.forward_ms = [a.elapsed_time(b) for a, b in events]
        run.trace = tracer.summary()
        run.traced_units = tracer.units

    def answers(self):
        """(input index per answer row, logits, answers missing)."""
        calls = sorted(self.kept)
        if not calls:
            return np.zeros(0, np.int64), np.zeros((0, 0), np.float32), 0
        idx = np.concatenate([(c % self.n_ring) * self.batch
                              + np.arange(self.batch) for c in calls])
        return idx, np.concatenate([self.kept[c] for c in calls]), 0

    def close(self) -> None:
        self.kept.clear()
