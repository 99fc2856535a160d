"""Checkpoint save / restore with ``torch.save``: the port of
``pose3d_tpu/train/checkpoint.py``. The reference's run layout
``<log_dir>/models/<run_name>`` (train_1.py:186) holds the step, the model
and optimizer state dicts and the plateau scheduler's state; a
``.meta.json`` sidecar beside it holds run metadata that shapes cannot
carry (``batch_size`` and, for the temporal lifter, ``heads``,
``hidden``, ``n_blocks``, ``clip_len``). ``save`` writes a temporary file
and renames it, so a checkpoint is whole or absent. ``peek_params`` and
``restore_params`` read the model's state dict alone (its parameters and
BatchNorm buffers, no optimizer), for inference and for reusing a trained
model in another run; they read the port's checkpoints, not the JAX
package's orbax ones.

In a data-parallel run (an initialised ``torch.distributed`` world)
rank 0 writes the checkpoint and every rank then meets at a barrier;
every rank restores the same file, and ``restore`` then checks that the
restored model and optimizer states are bitwise equal across the ranks.

A model cut over the model axis (``parallel/sharding.shard_params``)
keeps one format: ``save`` gathers its sharded parameters, running
statistics and their optimizer moments over the model axis, so the file
holds the tensors a one-process run writes for the same state, and
``peek_params`` / ``restore_params`` read it as any other. ``restore``
loads the whole file on every rank and keeps the rank's slices, with the
optimizer's moments in the shards' shapes; it checks replication over
the data axis, the ranks that hold the same shards.
"""

from __future__ import annotations

import json
import os
import pathlib

import torch

from pose3d_tpu_torch.parallel.mesh import (barrier, check_replicated, data_group,
                                            gather_model, is_writer, model_shard)
from pose3d_tpu_torch.parallel.sharding import gathered_state_dict, tp_layout
from pose3d_tpu_torch.train.state import TrainState


def _path(log_dir, run_name: str) -> pathlib.Path:
    return (pathlib.Path(log_dir) / "models" / run_name).absolute()


def _map_moments(opt_sd: dict, state: TrainState, fn) -> None:
    """``fn(tensor, dim)`` in place of each sharded parameter's optimizer
    state of the parameter's shape (Adam's moments; not its step count) in
    the optimizer's state dict ``opt_sd``."""
    spec = tp_layout(state.model)[1]
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        d = spec.get(names.get(id(p)))
        if d is not None and i in opt_sd["state"]:
            # a new dict: state_dict() shares the optimizer's own
            opt_sd["state"][i] = {k: fn(v, d) if torch.is_tensor(v) and v.dim() == p.dim()
                                  else v for k, v in opt_sd["state"][i].items()}


def save(state: TrainState, log_dir, run_name: str, *, batch_size: int | None = None,
         extra: dict | None = None) -> str:
    path = _path(log_dir, run_name)
    # every rank gathers its model axis' shards
    model_sd, opt_sd = gathered_state_dict(state.model), state.optimizer.state_dict()
    mesh = tp_layout(state.model)[0]
    if mesh is not None:
        _map_moments(opt_sd, state, lambda t, d: gather_model(t, d, mesh))
    if is_writer():
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"step": state.step, "model": model_sd, "optimizer": opt_sd,
                   "plateau": state.plateau.state_dict()}
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        with open(str(path) + ".meta.json", "w") as f:
            json.dump({"batch_size": batch_size or 0, **(extra or {})}, f)
    barrier()
    return str(path)


def load_meta(log_dir, run_name: str) -> dict:
    """The ``.meta.json`` sidecar ({} when absent)."""
    meta = pathlib.Path(str(_path(log_dir, run_name)) + ".meta.json")
    return json.loads(meta.read_text()) if meta.exists() else {}


def restore(state: TrainState, log_dir, run_name: str) -> tuple[TrainState, dict]:
    """Load a checkpoint into ``state`` (its model, optimizer and plateau
    schedule, in place, on the model's device); returns (state, meta). A
    sharded model takes this model rank's slices of the file's tensors."""
    device = next(state.model.parameters()).device
    payload = torch.load(_path(log_dir, run_name), map_location=device, weights_only=True)
    mesh, spec = tp_layout(state.model)
    if mesh is not None:
        for k, d in spec.items():
            payload["model"][k] = model_shard(payload["model"][k], d, mesh)
        _map_moments(payload["optimizer"], state, lambda t, d: model_shard(t, d, mesh))
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.plateau.load_state_dict(payload["plateau"])
    state.step = payload["step"]
    check_replicated([*state.model.state_dict().values(),
                      *(t for s in state.optimizer.state.values() for t in s.values()
                        if torch.is_tensor(t))],
                     group=None if mesh is None else data_group(mesh))
    return state, load_meta(log_dir, run_name)


def peek_params(log_dir, run_name: str) -> dict:
    """The model's state dict of a checkpoint, on the CPU, whatever the
    architecture: callers read the shapes to build the model."""
    payload = torch.load(_path(log_dir, run_name), map_location="cpu", weights_only=True)
    return payload["model"]


def restore_params(log_dir, run_name: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint's parameters and BatchNorm buffers into ``model``
    (strictly, on its device), and no optimizer state; returns ``model``."""
    model.load_state_dict(peek_params(log_dir, run_name), strict=True)
    return model


def exists(log_dir, run_name: str) -> bool:
    return _path(log_dir, run_name).exists()
