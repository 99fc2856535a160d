"""The (data, model) mesh over ``torch.distributed``: the port of
``pose3d_tpu/parallel/mesh.py``.

The JAX package names a (data, model) ``jax.sharding.Mesh`` and lets
``shard_map`` or GSPMD place the collectives. Here one process runs per
rank (``torchrun``, or spawned ranks in the tests), the mesh is a
``DeviceMesh`` over the initialised world with the same axis names, and
every collective is written out where the JAX step spells it. The data
axis splits the batch (data parallelism); the model axis splits the wide
layers' features (tensor parallelism, ``parallel/sharding.py``):

- ``shard_batch`` gives each rank its rows of a global batch in the JAX
  ``P(DATA_AXIS)`` order: rank r of the data axis holds rows
  ``[r·B/N, (r+1)·B/N)``;
- ``pmean_`` / ``psum_`` reduce a list of tensors in place with one
  ``all_reduce`` over a flat buffer (one a dtype), so gradients come out
  in a fixed order and bitwise the same on every rank. No DDP: its
  ``broadcast_buffers`` would overwrite averaged running statistics, and
  its bucketed hooks would hide the ``pmean`` the JAX steps spell out;
- ``broadcast_parameters`` (JAX's ``replicated``) copies rank 0's
  parameters and buffers to every rank;
- ``gather_model`` joins the model axis' shards of a tensor: each rank
  writes its shard into a zero-filled buffer, and one ``all_reduce`` of
  the buffer's bytes fills in the others' (``gloo`` has no all-gather of
  CUDA tensors; a byte sum against zeros is exact for any dtype).

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


def model_group(mesh):
    """The process group of this rank's model axis."""
    require_group(mesh)
    return mesh.get_group(MODEL_AXIS)


def model_size(mesh) -> int:
    """The number of ranks on the model axis."""
    return mesh.shape[mesh.mesh_dim_names.index(MODEL_AXIS)]


def model_rank(mesh) -> int:
    """This rank's index on the model axis."""
    require_group(mesh)
    return mesh.get_local_rank(MODEL_AXIS)


def gather_model(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The whole tensor whose shard on ``dim`` this rank holds (model rank
    r holds the r-th of ``model_size`` equal slices), the same bytes on
    every model rank; ``x`` itself over one rank. The shard goes into its
    slot of a zero-filled buffer and one ``all_reduce`` sums the buffer's
    bytes over the model group: each byte has one non-zero contributor, so
    the sum is a copy, exact for any dtype (-0.0 included), and it runs
    under ``gloo`` on CUDA tensors."""
    n = model_size(mesh)
    if n == 1:
        return x
    dim %= x.dim()
    w = x.shape[dim]
    full = x.new_zeros((*x.shape[:dim], w * n, *x.shape[dim + 1:]))
    full.narrow(dim, model_rank(mesh) * w, w).copy_(x)
    dist.all_reduce(full.view(-1).view(torch.uint8), group=model_group(mesh))
    return full


class _GatherModel(torch.autograd.Function):
    """``gather_model`` with its backward: where the consumer of the whole
    tensor is sharded (``reduce``), each model rank holds a partial
    gradient of it, so they are summed over the model group; where it is
    replicated, the gradient is already whole. Either way the rank keeps
    its slice."""

    @staticmethod
    def forward(ctx, x, dim, mesh, reduce):
        ctx.dim, ctx.mesh, ctx.reduce = dim, mesh, reduce
        return gather_model(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=model_group(ctx.mesh))
        return model_shard(g, ctx.dim, ctx.mesh), None, None, None


def gather_model_grad(x: torch.Tensor, dim: int, mesh, reduce: bool) -> torch.Tensor:
    """``gather_model`` through autograd: x (this rank's shard on ``dim``)
    -> the whole tensor. ``reduce``: the consumer is sharded over the model
    axis too, so the backward sums the ranks' gradients before slicing."""
    return _GatherModel.apply(x, dim, mesh, reduce)


def model_shard(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """This model rank's slice of ``x`` on ``dim`` (a contiguous copy):
    the inverse of ``gather_model``."""
    n = model_size(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} model ranks")
    w = x.shape[dim] // n
    return x.narrow(dim, model_rank(mesh) * w, w).contiguous()


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


def psum_model_(tensors, mesh) -> None:
    """Sum each tensor over the model axis, in place, in one ``all_reduce``
    (one a dtype)."""
    group = model_group(mesh)
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


def check_replicated(tensors, group=None) -> None:
    """Raise unless every tensor is bitwise the same on every rank of
    ``group`` (default: the initialised world) as on the group's first
    rank; a no-op for one process or a group of one. The first rank's flat
    bytes are broadcast and compared. Shards of the model axis are checked
    over their data axis' group, the ranks that hold the same shard."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for ts in _by_dtype(t.detach() for t in tensors):
        mine = _flatten_dense_tensors(ts)
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=group)
        if not torch.equal(mine.view(torch.uint8), ref.view(torch.uint8)):
            raise RuntimeError(f"rank {dist.get_rank()}: {mine.dtype} state differs "
                               f"bitwise from rank {src}'s")


def broadcast_parameters(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to data rank 0's, in
    one broadcast over a flat buffer (one a dtype); returns ``module``."""
    group = data_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        _flat_([*module.parameters(), *module.buffers()],
               lambda flat: dist.broadcast(flat, src=src, group=group))
    return module
