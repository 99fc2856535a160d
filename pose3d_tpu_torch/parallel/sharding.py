"""Tensor parallelism over the mesh's model axis: the port of
``pose3d_tpu/parallel/sharding.py``.

JAX's rule shards the last axis of every parameter whose last axis is at
least ``min_dim`` and divides over the model axis, replicates the rest,
and lets GSPMD place the collectives. The rule here is the same, read
through the flax -> torch layouts of ``interop/weights.py``: flax's last
axis is the output-feature axis, which is dim 0 of a ``Linear`` or
``Conv2d`` weight and of every bias and norm parameter, dim 1 of a
``ConvTranspose2d`` weight, and the last dim of a parameter the bridge
copies as it is (position embeddings, class tokens). The decision is
taken on that axis, the one JAX's rule sees: the Martinez head's weight
(51, 1024) passes 256 on its torch dim 1, but its flax last axis is 51,
so it stays replicated.

``shard_params`` cuts a ``MartinezLifter`` or ``AELifter`` (the
Linear / BatchNorm1d stacks that the JAX package shards) down to this
rank's shards, in place, and its forward then runs on them, with the
collectives written out:

- a sharded ``Linear`` takes the whole input and gives its rank's output
  features; an input that is a feature shard is gathered over the model
  axis first (``gather_model``), and so is the replicated head's;
- BatchNorm, ReLU, dropout and the residual adds work on the rank's
  feature shard; a BatchNorm bound global (``models/norm.sync_batch_norm``)
  reduces its per-channel sums over the data axis, so its shard of the
  running statistics updates only its own channels;
- the gather's backward sums the model ranks' partial input gradients
  (each holds dY_j W_j) and keeps the rank's slice where the consumer is
  sharded, and only slices where it is replicated (the head, whose input
  gradient is already whole on every model rank);
- dropout draws the full-width mask from the generator, as one process
  does, and keeps the rank's columns: the model ranks of one data rank
  share its stream (``shard_seed(seed, data_rank)``), so a 1 x 2 mesh
  draws the masks of one process.

The model keeps its mesh and the state-dict keys it holds sharded with
their dims, which ``tp_layout`` reads: the steps, the global-norm clip
(``tp_shards``) and the checkpoint (``gathered_state_dict``) ask it.
``shard_params`` refuses every other model: no JAX path runs tensor
parallelism on it.

Sequence parallelism (JAX's ``TemporalLifter(activation_spec=...)``):
``sequence_parallel`` binds a mesh to a ``TemporalLifter`` whose spec
splits the frames over the model axis; its forward then runs on the
rank's frames (``models/temporal.py``). Its parameters stay whole on
every rank, and each rank's gradients cover its own frames only, so the
steps sum them over the model group (``sequence_mesh``) before averaging
over the data axis; the clip then reads whole gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pose3d_tpu_torch.parallel.mesh import (gather_model, gather_model_grad, model_rank,
                                            model_shard, model_size)

# the layers whose forward runs on feature shards
_TP_LAYERS = (nn.Linear, nn.modules.batchnorm._BatchNorm, nn.ReLU, nn.Dropout, nn.Flatten)


def _flax_last_dim(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The torch dim of ``module``'s parameter ``name`` that holds the flax
    parameter's last axis (``interop/weights.py``'s layouts)."""
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return 1  # (in, out, kh, kw) from flax's (kh, kw, in, out)
    if isinstance(module, (nn.Linear, nn.modules.conv._ConvNd)) or p.dim() == 1:
        return 0  # (out, in[, kh, kw]) from (in, out) / (kh, kw, in, out); 1-D as it is
    return p.dim() - 1  # copied as it is


def infer_param_sharding(model: nn.Module, mesh, min_dim: int = 256) -> dict[str, int | None]:
    """{parameter name: the dim it is sharded on over the model axis, or
    None where it is replicated}, JAX's rule on the flax shape of each
    parameter of any model: sharded where the model axis has more than
    one rank and the flax last axis is at least ``min_dim`` and divides
    over it. Reads the mesh's shape only."""
    tp = model_size(mesh)
    rule = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            d = _flax_last_dim(m, pname, p) if p.dim() else None
            n = p.shape[d] if d is not None else 0
            rule[f"{mname}.{pname}" if mname else pname] = (
                d if tp > 1 and n >= min_dim and n % tp == 0 else None)
    return {name: rule[name] for name, _ in model.named_parameters()}


class _TPLinear(nn.Linear):
    """A ``Linear`` of a sharded model: ``sharded`` where its weight and
    bias hold this rank's output features. An input narrower than
    ``in_features`` is a feature shard, gathered first."""

    tp_mesh = None
    sharded = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            x = gather_model_grad(x, -1, self.tp_mesh, self.sharded)
        return super().forward(x)


class _TPDropout(nn.Dropout):
    """Dropout on a feature shard: the full-width mask drawn as one
    process draws it, the rank's columns kept."""

    tp_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        n, w = model_size(self.tp_mesh), x.shape[-1]
        keep = F.dropout(x.new_ones((*x.shape[:-1], w * n)), self.p, True)
        return x * keep.narrow(-1, model_rank(self.tp_mesh) * w, w)


def _refuse(model: nn.Module) -> None:
    from pose3d_tpu_torch.models.lifters import AELifter, MartinezLifter

    if isinstance(model, (MartinezLifter, AELifter)):
        return
    layer = next((m for m in model.modules() if not isinstance(m, _TP_LAYERS)
                  and not any(m.children())), model)
    raise ValueError(f"shard_params shards the Linear / BatchNorm1d lifters (MartinezLifter, "
                     f"AELifter) only; {type(model).__name__} has a {type(layer).__name__}, "
                     "which it cannot shard")


@torch.no_grad()
def shard_params(model: nn.Module, mesh, min_dim: int = 256) -> nn.Module:
    """Cut ``model``'s parameters that ``infer_param_sharding`` shards, and
    their BatchNorms' running statistics, down to this model rank's
    slices, in place (the Parameter objects stay, so an optimizer made
    before keeps them), and run its forward on the shards from here on;
    returns ``model``. Load the full weights first. With nothing to shard
    (one model rank, or layers under ``min_dim``) the model is unchanged
    and only records the mesh. Raises ValueError on a model other than
    ``MartinezLifter`` / ``AELifter`` or one already sharded."""
    _refuse(model)
    if tp_layout(model)[0] is not None:
        raise ValueError(f"{type(model).__name__} is already sharded")
    rule = infer_param_sharding(model, mesh, min_dim)
    spec: dict[str, int] = {}
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, p in m.named_parameters(recurse=False):
            d = rule[prefix + pname]
            if d is not None:
                p.data = model_shard(p.data, d, mesh)
                spec[prefix + pname] = d
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and prefix + "weight" in spec:
            for b in ("running_mean", "running_var"):
                setattr(m, b, model_shard(getattr(m, b), 0, mesh))
                spec[prefix + b] = 0
            m.num_features = m.weight.shape[0]
    if spec:
        for mname, m in model.named_modules():
            prefix = f"{mname}." if mname else ""
            if isinstance(m, nn.Linear):
                m.__class__ = _TPLinear
                m.tp_mesh, m.sharded = mesh, prefix + "weight" in spec
                m.out_features = m.weight.shape[0]
            elif isinstance(m, nn.Dropout):
                m.__class__ = _TPDropout
                m.tp_mesh = mesh
    model.tp_mesh, model.tp_spec = mesh, spec
    return model


def tp_layout(model: nn.Module) -> tuple:
    """(the model's mesh, {state-dict key: the dim it is sharded on}) of a
    model that ``shard_params`` cut; (None, {}) for any other."""
    return getattr(model, "tp_mesh", None), getattr(model, "tp_spec", {})


def tp_shards(model: nn.Module) -> tuple:
    """(the model's mesh, its parameters held as model-axis shards) of a
    model that ``shard_params`` cut; (None, []) for any other."""
    mesh, spec = tp_layout(model)
    return mesh, [p for name, p in model.named_parameters() if name in spec]


def gathered_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with each sharded tensor gathered over the
    model axis: on every model rank, the tensors a one-process model
    holds. Any other model's state dict as it is."""
    mesh, spec = tp_layout(model)
    sd = model.state_dict()
    for k, d in spec.items():
        sd[k] = gather_model(sd[k], d, mesh)
    return sd


def require_tp_mesh(model: nn.Module, mesh) -> None:
    """Raise unless a step over ``mesh`` can run ``model``: a model cut by
    ``shard_params`` runs over the mesh it was cut for, and only there."""
    tp = tp_layout(model)[0]
    if tp is not None and tp is not mesh:
        raise ValueError(f"{type(model).__name__} is sharded over a mesh; its step must run "
                         "over that mesh" + (", and was given none" if mesh is None else ""))


def sequence_parallel(model: nn.Module, mesh) -> nn.Module:
    """Binds ``mesh`` to a ``TemporalLifter`` whose ``activation_spec``
    splits the frames over the model axis (``("data", "model", None,
    None)``), once, where the mesh meets the model; returns ``model``.
    Raises ValueError on any other model, or one bound already."""
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    if not isinstance(model, TemporalLifter) or not model.splits_frames:
        raise ValueError("sequence_parallel binds a TemporalLifter whose activation_spec "
                         "splits the frames over the model axis")
    if model.sp_mesh is not None:
        raise ValueError("the TemporalLifter is bound to a mesh already")
    model.sp_mesh = mesh
    return model


def sequence_mesh(model: nn.Module):
    """The mesh ``sequence_parallel`` bound to ``model``, or None."""
    return getattr(model, "sp_mesh", None)


def require_sequence_mesh(model: nn.Module, mesh) -> None:
    """Raise unless a step over ``mesh`` can run ``model``: a model bound by
    ``sequence_parallel`` runs over its mesh, and only there."""
    sp = sequence_mesh(model)
    if sp is not None and sp is not mesh:
        raise ValueError(f"{type(model).__name__} splits its frames over a mesh; its step must "
                         "run over that mesh" + (", and was given none" if mesh is None else ""))
