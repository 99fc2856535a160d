"""Data parallelism over ``torch.distributed``: the port of
``pose3d_tpu/parallel/mesh.py``.

The JAX package names a (data, model) ``jax.sharding.Mesh`` and lets
``shard_map`` or GSPMD place the collectives. Here one process runs per
rank (``torchrun``, or spawned ranks in the tests), the mesh is a
``DeviceMesh`` over the initialised world with the same axis names, and
every collective is written out where the JAX step spells it:

- ``shard_batch`` gives each rank its rows of a global batch in the JAX
  ``P(DATA_AXIS)`` order: rank r of the data axis holds rows
  ``[r·B/N, (r+1)·B/N)``;
- ``pmean_`` / ``psum_`` reduce a list of tensors in place with one
  ``all_reduce`` over a flat buffer (one a dtype), so gradients come out
  in a fixed order and bitwise the same on every rank. No DDP: its
  ``broadcast_buffers`` would overwrite averaged running statistics, and
  its bucketed hooks would hide the ``pmean`` the JAX steps spell out;
- ``broadcast_parameters`` (JAX's ``replicated``) copies rank 0's
  parameters and buffers to every rank.

Without a launcher nothing here runs: the trainers, the services and the
steps keep their one-process paths. Given a mesh, a step or service that
finds no process group raises; no path falls back to one process, and a
failed collective is not caught.

``init_distributed`` reads ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``. ``nccl`` takes one device a rank; ``gloo`` (the CPU, or
several ranks sharing one GPU, where its ``all_reduce``, ``broadcast``
and ``barrier`` take CUDA tensors) shares devices. A ``gloo`` world's
mesh is a CPU mesh whose groups carry the ranks' tensors, CUDA ones too.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

DATA_AXIS = "data"
MODEL_AXIS = "model"
_SEED_STRIDE = 1_000_003  # rank r's dropout stream: seed + r * this (a prime)


def launched() -> bool:
    """True under a launcher that set ``WORLD_SIZE`` (``torchrun``)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(backend: str | None = None, *, device_type: str = "cuda",
                     init_method: str | None = None) -> torch.device:
    """Join the process group of the launcher's world (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``init_method`` defaults to ``env://``,
    which reads ``MASTER_ADDR`` / ``MASTER_PORT``) and return this rank's
    device: ``cuda:LOCAL_RANK`` (modulo the devices, for ``gloo``) or the
    CPU. ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU.
    Raises where CUDA is asked for and absent, and where ``nccl`` would
    put two ranks on one device (NCCL would fail later with "Duplicate
    GPU"). A group already initialised is kept."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be cuda or cpu, got {device_type!r}")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_dev == 0:
            raise RuntimeError("init_distributed(device_type='cuda'): CUDA is not available")
        if backend == "nccl" and local >= n_dev:
            raise ValueError(f"nccl takes one device a rank: local rank {local} of "
                             f"{n_dev} CUDA device(s); use gloo to share a device")
        device = torch.device("cuda", local % n_dev)
        torch.cuda.set_device(device)
    else:
        if backend == "nccl":
            raise ValueError("nccl needs CUDA devices; the CPU takes gloo")
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(f"a process group of rank {dist.get_rank()} / "
                           f"{dist.get_world_size()} exists; the environment says "
                           f"{rank} / {world}")
    return device


@contextlib.contextmanager
def launched_mesh(device: str):
    """Under a launcher (``torchrun``): join its world on ``device``'s type
    (``init_distributed``), yield a mesh of every rank on the data axis,
    and leave the process group at the end. Otherwise yield None: one
    process, nothing changes."""
    if not launched():
        yield None
        return
    init_distributed(device_type=torch.device(device).type)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str | None = None):
    """A (data, model) ``DeviceMesh`` over the initialised world, all
    ranks on the data axis by default. ``device_type`` defaults to
    ``cuda`` for an ``nccl`` world and ``cpu`` otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} (data) x {n_model} (model) != world size {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def require_group(mesh) -> None:
    """Raise unless a process group is initialised for ``mesh``."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh was given but no process group is initialised")


def data_group(mesh):
    """The process group of this rank's data axis."""
    require_group(mesh)
    return mesh.get_group(DATA_AXIS)


def data_size(mesh) -> int:
    """The number of ranks on the data axis."""
    return mesh.shape[mesh.mesh_dim_names.index(DATA_AXIS)]


def data_rank(mesh) -> int:
    """This rank's index on the data axis."""
    require_group(mesh)
    return mesh.get_local_rank(DATA_AXIS)


def shard_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s dropout seed for a step seeded with ``seed`` (JAX's
    ``fold_in(key, axis_index)``): rank 0 draws the seed's own stream, so
    a world of one draws what one process does."""
    return seed + rank * _SEED_STRIDE


def shard_batch(batch, mesh):
    """This rank's rows of each array (numpy or tensor) of ``batch`` (an
    array or a tuple of them), in the JAX ``P(DATA_AXIS)`` order; raises on
    a batch that does not split evenly over the data axis."""
    n, r = data_size(mesh), data_rank(mesh)

    def rows(a):
        if len(a) % n:
            raise ValueError(f"a batch of {len(a)} does not split over {n} data ranks")
        b = len(a) // n
        return a[r * b:(r + 1) * b]

    if isinstance(batch, (tuple, list)):
        return type(batch)(rows(a) for a in batch)
    return rows(batch)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _by_dtype(tensors) -> list[list[torch.Tensor]]:
    """The tensors grouped by (dtype, device), in order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _flat_(tensors, fn) -> None:
    """``fn(flat)`` on one flat buffer of the tensors of each (dtype,
    device), then the values written back in place, in order: one
    flatten, ``fn``, one multi-tensor copy, each a single call whatever
    the count (a model has hundreds of gradients, and a Python loop over
    them costs milliseconds of host time a step)."""
    for ts in _by_dtype(tensors):
        flat = _flatten_dense_tensors(ts)
        fn(flat)
        torch._foreach_copy_(ts, _unflatten_dense_tensors(flat, ts))


def psum_(tensors, mesh) -> None:
    """Sum each tensor over the data axis, in place, in one ``all_reduce``
    (one a dtype)."""
    group = data_group(mesh)
    _flat_(list(tensors), lambda flat: dist.all_reduce(flat, group=group))


def pmean_(tensors, mesh) -> None:
    """Mean of each tensor over the data axis, in place: the sum of
    ``psum_`` divided by the axis' size on the flat buffer (exact for a
    world of one)."""
    group, n = data_group(mesh), data_size(mesh)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _flat_(list(tensors), mean)


def is_writer() -> bool:
    """True on the rank that writes files: rank 0 of an initialised world,
    or the one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """All ranks of an initialised world meet here; one process passes."""
    if dist.is_initialized():
        dist.barrier()


def check_replicated(tensors) -> None:
    """Raise unless every tensor is bitwise rank 0's on every rank of the
    initialised world (a no-op for one process): rank 0's flat bytes are
    broadcast and compared."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for ts in _by_dtype(t.detach() for t in tensors):
        mine = _flatten_dense_tensors(ts)
        ref = mine.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(mine.view(torch.uint8), ref.view(torch.uint8)):
            raise RuntimeError(f"rank {dist.get_rank()}: {mine.dtype} state differs "
                               "bitwise from rank 0's")


def broadcast_parameters(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to data rank 0's, in
    one broadcast over a flat buffer (one a dtype); returns ``module``."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        _flat_([*module.parameters(), *module.buffers()],
               lambda flat: dist.broadcast(flat, src=src, group=group))
    return module
