"""Serving: bucketed batch inference of a lifter, the port of
``pose3d_tpu/serving.py``.

- Batch sizes are powers of two from ``min_bucket`` to ``max_batch``; a
  request is zero-padded up to its bucket and the padding sliced off, and
  a request above the top bucket is served in top-bucket chunks.
- A bf16 ``JointTransformerLifter`` of the default architecture runs the
  fused forward (``ops/lifter.lifter_forward_fused``): on a CUDA device
  the trunk is the Hopper kernel. Any other model, or an f32 one, runs its
  ``nn.Module`` forward in its own dtype, so an f32 model keeps f32
  numerics.
"""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch.ops import lifter as _lifter


def fused_vit_buckets_ok(buckets) -> bool:
    """True iff every bucket is a whole number of the trunk kernel's frame
    tiles (``FRAMES_PER_CTA``); ``lifter_forward_fused`` raises on any
    other batch size, so the gate must route such configurations to the
    module's forward instead."""
    return all(b % _lifter.FRAMES_PER_CTA == 0 for b in buckets)


class LifterService:
    """Wraps a lifter for padded, bucketed batch inference on one device.

    ``state_dict`` (or None to keep the model's weights) is loaded with
    ``strict=True``. ``device`` is where the model runs; a CUDA device
    that is not available raises.
    """

    def __init__(self, model: torch.nn.Module, state_dict=None, *, device,
                 max_batch: int = 8192, min_bucket: int = 64,
                 use_fused_vit: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"LifterService(device={device!r}): CUDA is "
                               "not available")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.buckets = []
        b = min_bucket
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2
        if not self.buckets:
            raise ValueError(f"no bucket between {min_bucket} and {max_batch}")
        self.fused = (use_fused_vit and _lifter.supports(model)
                      and model.dtype == torch.bfloat16
                      and fused_vit_buckets_ok(self.buckets))
        self._weights = _lifter.pack_weights(model) if self.fused else None

    @torch.inference_mode()
    def _run(self, kp2d: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return _lifter.lifter_forward_fused(self.model, kp2d,
                                                weights=self._weights)
        return self.model(kp2d)

    def warmup(self):
        """Run every bucket once (the first request pays no first-call cost)."""
        for b in self.buckets:
            self._run(torch.zeros(b, self.model.n_joints, self.model.in_dim,
                                  device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def lift(self, kp2d: np.ndarray) -> np.ndarray:
        """(N, J, in_dim) -> (N, J, out_dim) f32; N arbitrary (chunked over
        the top bucket)."""
        kp2d = np.asarray(kp2d, np.float32)
        want = (self.model.n_joints, self.model.in_dim)
        if kp2d.ndim != 3 or kp2d.shape[1:] != want:
            raise ValueError(f"kp2d must be (N, {want[0]}, {want[1]}), got {kp2d.shape}")
        n = len(kp2d)
        out = np.empty((n, self.model.n_joints, self.model.out_dim), np.float32)
        top = self.buckets[-1]
        pos = 0
        while pos < n:
            chunk = torch.from_numpy(kp2d[pos: pos + top])
            take = len(chunk)
            b = self._bucket(take)
            x = torch.zeros((b, *chunk.shape[1:]), device=self.device)
            x[:take] = chunk.to(self.device)
            pred = self._run(x)
            out[pos: pos + take] = pred[:take].float().cpu().numpy()
            pos += take
        return out
