"""Sub-seeds of a run's ``--seed``, one a purpose, from numpy's SeedSequence
(any non-negative whole number, however large)."""

from __future__ import annotations

import numpy as np

PURPOSES = ("weights", "walk", "data", "trainer", "sample", "replay_scale")


def sub_seed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for ``purpose`` (one of :data:`PURPOSES`) and ``index``
    (-1 is the set-up's warm-up)."""
    key = [int(seed) % 2**64, PURPOSES.index(purpose), int(index) % 2**32]
    return int(np.random.SeedSequence(key).generate_state(2, np.uint32).view(np.uint64)[0] >> np.uint64(1))
