"""Host batches and their copy to the device: the port of
``pose3d_tpu/data/feed.py``.

``batch_iterator`` draws the same numpy permutation stream as the JAX
package's. ``prefetch_to_device`` keeps ``depth`` batches in flight: on a
CUDA device each batch is copied from pinned host memory with
``non_blocking`` copies on the current stream, so the copy of batch N+1
overlaps step N. With a mesh each rank stages only its shard of every
batch (``parallel.mesh.shard_batch``), as the JAX feed puts each chip's
shard on it directly.
"""

from __future__ import annotations

import collections
import itertools

import numpy as np
import torch

from pose3d_tpu_torch.parallel.mesh import shard_batch


def batch_iterator(arrays, batch_size: int, *, shuffle: bool, seed: int = 0,
                   drop_remainder: bool = True, epochs: int | None = None):
    """Yield tuples of numpy batches sliced from a (shuffled) permutation of
    equally long arrays, epoch after epoch; with ``drop_remainder`` the last
    partial batch of an epoch is dropped."""
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError("arrays differ in length")
    rng = np.random.default_rng(seed)
    epoch_iter = range(epochs) if epochs is not None else itertools.count()
    for _ in epoch_iter:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_remainder else n
        for start in range(0, end, batch_size):
            sel = idx[start:start + batch_size]
            yield tuple(a[sel] for a in arrays)


def prefetch_to_device(iterator, device, depth: int = 2, mesh=None):
    """Yield the batches of ``iterator`` as tensors on ``device``, with
    ``depth`` copies started ahead of the batch yielded; with ``mesh``
    only this rank's rows of each batch (which must split evenly over the
    data axis)."""
    device = torch.device(device)
    queue = collections.deque()

    def stage(batch):
        if mesh is not None:
            batch = shard_batch(tuple(batch), mesh)
        out = []
        for a in batch:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out.append(t)
        return tuple(out)

    for batch in iterator:
        queue.append(stage(batch))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
