"""Spawned ``torch.distributed`` ranks for the port's data-parallel tests.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` processes with the
``spawn`` start method (the parent holds JAX and threads; the children
import torch and the port only), each of which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``, takes one thread, joins a ``gloo``
group through a rendezvous file under ``tmp_path`` (no TCP port, so the
suite's xdist workers never collide), runs ``fn(*args)`` and saves what
it returns. The parent waits for all of them with a deadline: a rank
that fails ends the others at once, and a hung collective ends them all
at the deadline, so no test can stall the suite. ``fn`` must live in a
module the children can import without JAX (this one, or the port).
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

DEADLINE_S = 150.0


def _entry(fn, rank: int, world: int, out_dir: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from pose3d_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed("gloo", device_type="cpu",
                         init_method=f"file://{out_dir}/rdzv")
        result = fn(*args)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    except BaseException:
        Path(f"{out_dir}/rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S) -> list:
    """Run ``fn(*args)`` on ``world`` gloo ranks; returns each rank's
    result, or fails the test with the first failing rank's traceback."""
    out = Path(tmp_path) / f"ranks_{fn.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(out), args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < end:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
    errs = [f"rank {r}:\n{e.read_text()}" for r in range(world)
            if (e := out / f"rank{r}.err").exists()]
    if errs:
        pytest.fail("\n".join(errs))
    if hung:
        pytest.fail(f"ranks {hung} still running after {deadline} s: a hung collective")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        pytest.fail(f"ranks exited with {bad}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


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
