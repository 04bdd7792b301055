"""Seeded streams and the sample of calls a run keeps for its check."""

from __future__ import annotations

import random
from typing import Optional


def stream(seed: int, name: str) -> random.Random:
    """A host stream of its own for each use (`name`), fixed by the seed, so
    that one use drawing more never shifts another's draws."""
    return random.Random(f"{seed}:{name}")


def device_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from the run's seed (any
    whole number) and further parts (an input, a rank, a block)."""
    return stream(seed, "device:" + ":".join(map(str, parts))).getrandbits(63)


class Reservoir:
    """A uniform sample of at most `k` of the items offered (Algorithm R),
    drawn from `rng`. The draw does not depend on the item, so a place is
    asked for before the item is made (:meth:`slot`), and an item that the
    sample will not keep is never held."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng = int(k), rng
        self.items: list = []
        self.seen = 0

    def slot(self) -> Optional[int]:
        """The place of the next item in the sample, or None where it is not
        kept. The item that held the place is dropped at once."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self.rng.randrange(self.seen)
        if j >= self.k:
            return None
        self.items[j] = None
        return j

    def clear(self) -> None:
        self.items.clear()
        self.seen = 0
