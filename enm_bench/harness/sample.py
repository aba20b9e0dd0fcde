"""
A uniform sample of a fixed size, drawn from the seed, over a stream of
answers whose length the window decides: every answer gets a key from
the seed's own stream, and the answers with the `size` smallest keys are
the sample.
"""

from __future__ import annotations

import numpy as np


class Sample:
    def __init__(self, size, seed):
        self.size = int(size)
        self._rng = np.random.default_rng([int(seed), 0x5A4D])
        self._kept = np.empty(0)

    def threshold(self):
        if self._kept.size < self.size:
            return np.inf
        return np.partition(self._kept, self.size - 1)[self.size - 1]

    def offer(self, count):
        """Keys for `count` new answers; returns ``(positions, keys)`` of
        those that enter the sample (for now)."""
        keys = self._rng.random(count)
        take = np.flatnonzero(keys < self.threshold())
        self._kept = np.concatenate([self._kept, keys[take]])
        if self._kept.size > 4 * self.size:
            self._kept = np.sort(self._kept)[:self.size]
        return take, keys[take]
