"""Spawned ``torch.distributed`` ranks for the port's data-parallel tests.

``spawn(fn, world, tmp_path, *args)`` runs ``fn(*args)`` on ``world``
``gloo`` ranks on the CPU through the port's ``parallel.dryrun.run_ranks``:
processes of the ``spawn`` start method (the parent holds JAX and
threads; the children import torch and the port only), one thread each,
meeting through a rendezvous file under ``tmp_path`` (no TCP port, so
the suite's xdist workers never collide). A rank that fails ends the
others at once, and a hung collective ends them all at the deadline, so
no test can stall the suite. ``fn`` must live in a module the children
can import without JAX (this one, ``torch_dist_cases``, or the port).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pose3d_tpu_torch.parallel.dryrun import RankError, run_ranks

DEADLINE_S = 150.0


def spawn(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S) -> list:
    """Run ``fn(*args)`` on ``world`` gloo ranks; returns each rank's
    result, or fails the test with the failing ranks' tracebacks."""
    try:
        return run_ranks(fn, world, "cpu", *args, deadline=deadline, dir=tmp_path)
    except RankError as e:
        pytest.fail(str(e))


def numpy_tree(obj):
    """Tensors in nested dicts, lists and tuples -> numpy arrays."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(numpy_tree(v) for v in obj)
    return obj


def assert_ranks_bitwise_equal(results, key: str) -> None:
    """Every rank's ``results[r][key]`` (a dict of arrays) is rank 0's, bit
    for bit."""
    ref = results[0][key]
    for r, res in enumerate(results[1:], 1):
        for name, v in res[key].items():
            np.testing.assert_array_equal(np.asarray(v), np.asarray(ref[name]),
                                          err_msg=f"rank {r} {key}.{name}")
