"""Train state: model, optimizer and plateau schedule, the port of
``pose3d_tpu/train/state.py``.

``make_optimizer`` follows the JAX package's: AdamW with the torch default
decoupled weight decay of 1e-2 (the reference's bare ``AdamW(lr)``), Adam
with coupled weight decay (default 0), or SGD; optax's global-norm clip
when ``grad_clip`` is set. ``torch.optim.AdamW`` is the update
``optax.adamw`` computes (``tests/test_reference_parity_train.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from pose3d_tpu_torch.parallel.mesh import model_group
from pose3d_tpu_torch.train.schedule import make_plateau


def module_apply(model, x):
    """The default ``TrainState.apply``: the module's own forward."""
    return model(x)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    plateau: torch.optim.lr_scheduler.ReduceLROnPlateau
    apply: Callable = module_apply  # (model, x) -> prediction
    grad_clip: float = 0.0
    step: int = 0

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]


def make_optimizer(params, lr: float, kind: str = "adamw",
                   weight_decay: float | None = None) -> torch.optim.Optimizer:
    """AdamW (decoupled decay, default 1e-2), Adam or SGD (coupled decay,
    default 0), as ``pose3d_tpu.train.state.make_optimizer``."""
    if kind not in ("adamw", "adam", "sgd"):
        raise ValueError(kind)
    if weight_decay is None:
        weight_decay = 1e-2 if kind == "adamw" else 0.0
    cls = {"adamw": torch.optim.AdamW, "adam": torch.optim.Adam, "sgd": torch.optim.SGD}[kind]
    return cls(params, lr=lr, weight_decay=weight_decay)


def clip_by_global_norm(params, max_norm: float, mesh=None, shards=()) -> None:
    """optax.clip_by_global_norm in place: every gradient times max_norm /
    norm when the global norm exceeds max_norm, the squares summed in at
    least f32 (in the gradients' dtype where wider, as optax sums).

    ``mesh``, ``shards``: the parameters of ``shards`` hold this rank's
    slices over the mesh's model axis (``parallel.sharding.tp_shards``),
    so their squares are summed over the model group; the others are
    replicated there and counted once."""
    grads = [p.grad for p in params if p.grad is not None]
    sharded = {id(p.grad) for p in shards if p.grad is not None}
    acc = torch.promote_types(grads[0].dtype, torch.float32)
    zero = grads[0].new_zeros((), dtype=acc)
    local = sum((g.to(acc).square().sum() for g in grads if id(g) in sharded), zero)
    if mesh is not None and sharded:
        dist.all_reduce(local, group=model_group(mesh))
    norm = torch.sqrt(local + sum((g.to(acc).square().sum() for g in grads
                                   if id(g) not in sharded), zero))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def create_train_state(model: torch.nn.Module, lr: float, optimizer: str = "adamw",
                       weight_decay: float | None = None, grad_clip: float = 0.0,
                       apply: Callable | None = None) -> TrainState:
    opt = make_optimizer(model.parameters(), lr, optimizer, weight_decay)
    return TrainState(model=model, optimizer=opt, plateau=make_plateau(opt),
                      apply=apply or module_apply, grad_clip=grad_clip)
