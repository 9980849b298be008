"""Pieces the traffic drivers share."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (reservoir sampling: the same seed and count keep the same items)."""

    def __init__(self, rng: np.random.Generator, k: int):
        self.rng, self.k = rng, k
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
