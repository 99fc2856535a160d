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
"""

from __future__ import annotations

import json
import os
import pathlib

import torch

from pose3d_tpu_torch.parallel.mesh import barrier, check_replicated, is_writer
from pose3d_tpu_torch.train.state import TrainState


def _path(log_dir, run_name: str) -> pathlib.Path:
    return (pathlib.Path(log_dir) / "models" / run_name).absolute()


def save(state: TrainState, log_dir, run_name: str, *, batch_size: int | None = None,
         extra: dict | None = None) -> str:
    path = _path(log_dir, run_name)
    if is_writer():
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"step": state.step, "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
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
    schedule, in place, on the model's device); returns (state, meta)."""
    device = next(state.model.parameters()).device
    payload = torch.load(_path(log_dir, run_name), map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.plateau.load_state_dict(payload["plateau"])
    state.step = payload["step"]
    check_replicated([*state.model.state_dict().values(),
                      *(t for s in state.optimizer.state.values() for t in s.values()
                        if torch.is_tensor(t))])
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
