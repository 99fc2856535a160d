"""Per-epoch metric logging: the port of ``pose3d_tpu/train/logging.py``.
Every run appends one JSON object per epoch to
``<log_dir>/runs/<run_name>.jsonl`` (after a ``config`` record, and a
``finish`` record at the end) and prints the reference's line
(train_1.py:154). With ``WANDB=1`` in the environment (or
``use_wandb=True``) each epoch is mirrored to wandb under the reference's
key names (``WANDB_KEYS``; train_1.py:151, the leading space of the val
MPJPE key kept), where the package imports and its ``init`` succeeds;
otherwise the mirror stays off and the run goes on. In a data-parallel
run only rank 0 writes, prints and mirrors; ``finish`` is a barrier of
every rank.
"""

from __future__ import annotations

import json
import os
import pathlib
import time

from pose3d_tpu_torch.parallel.mesh import barrier, is_writer


class MetricLogger:
    WANDB_KEYS = {
        "train_loss": "loss(train)",
        "val_loss": "loss(val.)",
        "train_mpjpe": "MPJPE(train)",
        "val_mpjpe": " MPJPE(val.)",
    }

    def __init__(self, log_dir, run_name: str, config: dict | None = None,
                 use_wandb: bool | None = None):
        self.run_name = run_name
        self.path = pathlib.Path(log_dir) / "runs" / f"{run_name}.jsonl"
        self.writer = is_writer()
        self.t0 = time.time()
        self._wandb = None
        if not self.writer:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if use_wandb is None:
            use_wandb = os.environ.get("WANDB", "0") == "1"
        if use_wandb:
            try:
                import wandb

                wandb.init(project="loop", name=run_name, config=config or {})
                self._wandb = wandb
            except Exception as e:  # the mirror is optional: the run goes on
                print(f"wandb mirror off: {e!r}", flush=True)
        if config:
            self._write({"event": "config", **config})

    def _write(self, record: dict) -> None:
        if not self.writer:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_epoch(self, epoch: int, n_epochs: int, train_loss: float, train_mpjpe: float,
                  val_loss: float, val_mpjpe: float, **extra) -> None:
        if not self.writer:
            return
        self._write({"epoch": epoch + 1, "train_loss": train_loss, "train_mpjpe": train_mpjpe,
                     "val_loss": val_loss, "val_mpjpe": val_mpjpe,
                     "_runtime": round(time.time() - self.t0, 2), **extra})
        if self._wandb is not None:
            values = {"train_loss": train_loss, "val_loss": val_loss,
                      "train_mpjpe": train_mpjpe, "val_mpjpe": val_mpjpe}
            self._wandb.log({self.WANDB_KEYS[k]: v for k, v in values.items()})
        print(f"epoch {epoch + 1}/{n_epochs} loss(train): {train_loss:.4f} , "
              f"MPJPE(train):{train_mpjpe}, loss(val.): {val_loss}, "
              f"MPJPE(val.){val_mpjpe}", flush=True)

    def finish(self) -> None:
        self._write({"event": "finish", "_runtime": round(time.time() - self.t0, 2)})
        if self._wandb is not None:
            self._wandb.finish()
        barrier()
