"""Per-epoch metric logging: the port of ``pose3d_tpu/train/logging.py``.
Every run appends one JSON object per epoch to
``<log_dir>/runs/<run_name>.jsonl`` (after a ``config`` record, and a
``finish`` record at the end) and prints the reference's line
(train_1.py:154). The JAX package's optional wandb mirror is not ported.
"""

from __future__ import annotations

import json
import pathlib
import time


class MetricLogger:
    def __init__(self, log_dir, run_name: str, config: dict | None = None):
        self.run_name = run_name
        self.path = pathlib.Path(log_dir) / "runs" / f"{run_name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.t0 = time.time()
        if config:
            self._write({"event": "config", **config})

    def _write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_epoch(self, epoch: int, n_epochs: int, train_loss: float, train_mpjpe: float,
                  val_loss: float, val_mpjpe: float, **extra) -> None:
        self._write({"epoch": epoch + 1, "train_loss": train_loss, "train_mpjpe": train_mpjpe,
                     "val_loss": val_loss, "val_mpjpe": val_mpjpe,
                     "_runtime": round(time.time() - self.t0, 2), **extra})
        print(f"epoch {epoch + 1}/{n_epochs} loss(train): {train_loss:.4f} , "
              f"MPJPE(train):{train_mpjpe}, loss(val.): {val_loss}, "
              f"MPJPE(val.){val_mpjpe}", flush=True)

    def finish(self) -> None:
        self._write({"event": "finish", "_runtime": round(time.time() - self.t0, 2)})
