"""A data set's blocks as worker processes hand them back: block ``b`` is
stream ``b`` of ``quest.generate``, bit-packed along its items for the trip
(an eighth of the dense int8 bytes).  Imports numpy alone, so a worker
starts in a fraction of a second."""

from __future__ import annotations

import numpy as np

from bench.data import quest


def packed(q: quest.Quest, data_seed: int, rows: int, stream: int) -> np.ndarray:
    """Block ``stream`` of ``rows`` rows, ``np.packbits`` along the items."""
    return np.packbits(quest.generate(q, data_seed, rows, stream), axis=1)


def unpacked(bits: np.ndarray, num_items: int) -> np.ndarray:
    """A :func:`packed` block as dense {0,1} int8 rows again."""
    return np.unpackbits(bits, axis=1, count=num_items).view(np.int8)
