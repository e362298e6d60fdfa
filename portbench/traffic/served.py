"""What the served loops share: single-image requests drawn from a pool
of ``pool`` seeded images (made on the device, then copied to the host as
callers' images would be) through a ``BatchServer`` over the entry."""
from __future__ import annotations

import numpy as np

from .. import system, weights

WAIT_S = 60.0   # how long past the window an answer may still come


class Served:
    def __init__(self, entry, mix: dict, gen, device, seed: int,
                 image_shape):
        self.mix = mix
        self.batch = mix["batch"]
        self.inputs = weights.images(
            gen, (mix["pool"],) + tuple(image_shape), device)
        self.pool = self.inputs.cpu().numpy()
        self.rng = np.random.default_rng(seed)
        self.server = system.batch_server(entry, mix, image_shape)
        self.answered = []   # (pool index, logits) per request answered
        self.missing = 0

    def warm(self) -> None:
        """Full flushes and a padded one: the graph at the batch's shape
        is the only one a flush uses."""
        n = 4 * self.batch + 1
        futs = [self.server.submit(self.pool[i % len(self.pool)])
                for i in range(n)]
        for f in futs:
            f.result()

    def stats(self) -> dict:
        s = self.server.stats
        return {k: s[k] for k in ("requests", "flushes", "padded_rows")}

    def answers(self):
        if not self.answered:
            return (np.zeros(0, np.int64), np.zeros((0, 0), np.float32),
                    self.missing)
        idx = np.array([i for i, _ in self.answered], np.int64)
        return idx, np.stack([o for _, o in self.answered]), self.missing

    def close(self) -> None:
        self.server.close()
        self.answered = []
