"""Serving: bucketed batch inference of a lifter, the port of
``pose3d_tpu/serving.py``.

- Batch sizes are powers of two from ``min_bucket`` to ``max_batch``; a
  request is zero-padded up to its bucket and the padding sliced off, and
  a request above the top bucket is served in top-bucket chunks.
- A bf16 ``JointTransformerLifter`` of the default architecture runs the
  fused forward (``ops/lifter.lifter_forward_fused``): on a CUDA device
  the trunk is the Hopper kernel.
- A bf16 ``MartinezLifter`` with BatchNorm and hidden 1024 runs the fused
  inference (``ops/martinez.martinez_infer_fused``) on its weights packed
  once, every stage it has: on a CUDA device each residual block is the
  Hopper kernel.
- Any other model (an ``AELifter``, an f32 model, other widths) runs its
  ``nn.Module`` forward in its own dtype, so an f32 model keeps f32
  numerics.

Every family answers (N, 17, 2) keypoints with (N, 17, 3) poses: the
flat lifters' (N, 51) outputs are reshaped per joint, as the JAX service
does.

With ``mesh=`` (data-parallel serving, ``parallel/mesh.py``) every rank
calls ``lift`` with the same request. The buckets are multiples of the
data axis' size; each rank runs its rows of the padded bucket through the
route one process would take (the gate tests the per-shard bucket), and
writes them into a zero-filled f32 buffer of the whole bucket, which one
``all_reduce`` sums: adding zeros is exact, so every rank gets, bitwise,
the gather of the shards (``gloo`` has no all-gather of CUDA tensors).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.ops import lifter as _lifter
from pose3d_tpu_torch.ops import martinez as _martinez
from pose3d_tpu_torch.parallel.mesh import (data_group, data_rank, data_size, pad_to_multiple,
                                            shard_batch)
from pose3d_tpu_torch.train.debug import span

N_JOINTS = 17


def fused_vit_buckets_ok(buckets, n_shards: int = 1) -> bool:
    """True iff every per-shard bucket is a whole number of the trunk
    kernel's frame tiles (``FRAMES_PER_CTA``); ``lifter_forward_fused``
    raises on any other batch size, so the gate must route such
    configurations to the module's forward instead."""
    return all((b // n_shards) % _lifter.FRAMES_PER_CTA == 0 for b in buckets)


def _io_shapes(model) -> tuple[tuple[int, int], tuple[int, int]]:
    """Per-frame (input, output) shapes: (joints, in_dim), (joints, out_dim)
    for the joint-token ViT, the flat widths split over 17 joints for the
    others."""
    if isinstance(model, JointTransformerLifter):
        return (model.n_joints, model.in_dim), (model.n_joints, model.out_dim)
    if model.in_dim % N_JOINTS or model.out_dim % N_JOINTS:
        raise ValueError(f"in_dim {model.in_dim} and out_dim {model.out_dim} must "
                         f"split over {N_JOINTS} joints")
    return ((N_JOINTS, model.in_dim // N_JOINTS),
            (N_JOINTS, model.out_dim // N_JOINTS))


class LifterService:
    """Wraps a lifter for padded, bucketed batch inference on one device.

    ``state_dict`` (or None to keep the model's weights) is loaded with
    ``strict=True``. ``device`` is where the model runs (this rank's,
    under a mesh); a CUDA device that is not available raises. ``fused``
    says whether a fused route (ViT trunk or Martinez blocks) serves the
    model. ``mesh``: each bucket split over the mesh's data axis.

    ``frames_served`` and ``frames_padded`` count, over every service of
    the process, the frames ``lift`` was asked for and the zero frames it
    added to fill their buckets.
    """

    frames_served = 0
    frames_padded = 0

    def __init__(self, model: torch.nn.Module, state_dict=None, *, device,
                 max_batch: int = 8192, min_bucket: int = 64,
                 use_fused_vit: bool = True, use_fused_martinez: bool = True, mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"LifterService(device={device!r}): CUDA is "
                               "not available")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.in_shape, self.out_shape = _io_shapes(model)
        self.mesh = mesh
        n_shards = 1
        if mesh is not None:
            self._group = data_group(mesh)  # raises without a process group
            n_shards = data_size(mesh)
            # every bucket splits evenly over the data axis
            min_bucket = pad_to_multiple(max(min_bucket, n_shards), n_shards)
        self.buckets = []
        b = min_bucket
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2
        if not self.buckets:
            raise ValueError(f"no bucket between {min_bucket} and {max_batch}")
        # the fused routes compute in bf16: only bf16 models take them
        bf16 = getattr(model, "dtype", None) == torch.bfloat16
        if (use_fused_vit and bf16 and _lifter.supports(model)
                and fused_vit_buckets_ok(self.buckets, n_shards)):
            self._forward = functools.partial(
                _lifter.lifter_forward_fused, model, weights=_lifter.pack_weights(model))
        elif use_fused_martinez and bf16 and _martinez.supports(model):
            self._forward = functools.partial(
                _martinez.martinez_infer_fused, _martinez.pack_martinez(model))
        else:
            self._forward = model
        self.fused = self._forward is not model

    @torch.inference_mode()
    def _run(self, kp2d: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return self._forward(kp2d)
        # this rank's rows into a zero-filled whole; one all_reduce sums them
        n, rows = len(kp2d), shard_batch(kp2d, self.mesh)
        out = self._forward(rows).float().reshape(len(rows), -1)
        full = torch.zeros((n, out.shape[1]), device=out.device)
        r = data_rank(self.mesh)
        full[r * len(rows):(r + 1) * len(rows)] = out
        dist.all_reduce(full, group=self._group)
        return full

    def warmup(self):
        """Run every bucket once (the first request pays no first-call cost)."""
        for b in self.buckets:
            self._run(torch.zeros(b, *self.in_shape, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def lift(self, kp2d: np.ndarray) -> np.ndarray:
        """(N, J, in) -> (N, J, out) f32 (J = 17, (2, 3) for the served
        lifters); N arbitrary (chunked over the top bucket). Each chunk
        adds its frames to ``frames_served`` and its bucket's padding to
        ``frames_padded``."""
        with span("pose3d.serve.lift"):
            kp2d = np.asarray(kp2d, np.float32)
            if kp2d.ndim != 3 or kp2d.shape[1:] != self.in_shape:
                raise ValueError(f"kp2d must be (N, {self.in_shape[0]}, "
                                 f"{self.in_shape[1]}), got {kp2d.shape}")
            n = len(kp2d)
            out = np.empty((n, *self.out_shape), np.float32)
            top = self.buckets[-1]
            pos = 0
            while pos < n:
                with span("pose3d.serve.stage"):
                    chunk = torch.from_numpy(kp2d[pos: pos + top])
                    take = len(chunk)
                    b = self._bucket(take)
                    x = torch.zeros((b, *chunk.shape[1:]), device=self.device)
                    x[:take] = chunk.to(self.device)
                with span("pose3d.serve.forward"):
                    pred = self._run(x)
                with span("pose3d.serve.fetch"):
                    out[pos: pos + take] = pred[:take].float().cpu().numpy().reshape(
                        take, *self.out_shape)
                LifterService.frames_served += take
                LifterService.frames_padded += b - take
                pos += take
            return out
