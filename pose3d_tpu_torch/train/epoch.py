"""Host-side epoch helpers: the port of ``stack_batches`` of
``pose3d_tpu/train/epoch.py`` (the scanned lifter epochs come with the
phase-1 trainer)."""

from __future__ import annotations

import numpy as np


def stack_batches(arrays, batch_size: int, rng=None):
    """Shuffle (with ``rng``, a numpy Generator) and reshape (N, ...)
    arrays into (n_batches, batch_size, ...), dropping the remainder (the
    reference's DataLoader keeps a partial batch, a documented deviation
    that only moves the epoch's boundary)."""
    n = len(arrays[0])
    idx = rng.permutation(n) if rng is not None else np.arange(n)
    n_batches = n // batch_size
    idx = idx[: n_batches * batch_size]
    return tuple(a[idx].reshape(n_batches, batch_size, *a.shape[1:]) for a in arrays)
