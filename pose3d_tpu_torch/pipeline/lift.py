"""Sequence lifting inference: video 2D-keypoint JSON -> (T,17,3) npy; the
port of ``pose3d_tpu/pipeline/lift.py``.

Keypoints (x, y and, for a DSTformer, a confidence) are normalized by
the image size, cut into overlapping clips,
lifted in one batched call on the model's device, and the overlapping
predictions averaged back into a (T,17,3) float32 sequence.
"""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch.models.temporal import clip_starts, make_clips
from pose3d_tpu_torch.ops import stblock
from pose3d_tpu_torch.pipeline.keypoints import load_video_json, save_mb_npy
from pose3d_tpu_torch.train.debug import span


def lift_sequence(model, kp2d_px: np.ndarray, image_size: float = 1000.0,
                  stride: int | None = None, use_kernels: bool | None = None):
    """(T,17,in_dim) pixel keypoints -> (T,17,3) lifted sequence, on the
    device of ``model`` (a ``TemporalLifter`` or a ``DSTformer``).

    ``in_dim`` is the model's: x and y, divided by ``image_size``, and for
    a model of ``in_dim`` 3 a per-joint confidence, passed unchanged.

    Clips of ``model.clip_len`` frames (of T, where T is shorter) with
    ``stride`` overlap (default: half a clip); overlapping frame
    predictions are averaged; every frame is covered (``clip_starts``
    anchors a final window at the tail).

    ``use_kernels``: None (default) takes the kernels for a bfloat16 model
    only, so that an f32 model keeps f32 numerics. With kernels, full-length
    clips of a ``TemporalLifter`` of the kernels' widths run the fused
    forward (``ops.stblock.temporal_forward_fused``: one spatial and one
    temporal sub-block kernel per block), and anything else the module with
    its attention kernels. On the CPU every kernel runs its plain version.

    Counts, process-wide: each call in ``lift_sequence.videos``, its T in
    ``.frames`` and the frames its clips run (overlaps counted each time)
    in ``.clip_frames``.
    """
    t_total = kp2d_px.shape[0]
    lift_sequence.videos += 1
    lift_sequence.frames += t_total
    if t_total == 0:
        return np.zeros((0, 17, 3), np.float32)
    if kp2d_px.shape[-1] != model.in_dim:
        raise ValueError(f"keypoints of {kp2d_px.shape[-1]} channels for a model of in_dim "
                         f"{model.in_dim}")
    clip_len = min(model.clip_len, t_total)
    stride = stride or max(clip_len // 2, 1)
    with span("pose3d.lift_sequence.clips"):
        kp = np.asarray(kp2d_px)
        xy = kp[..., :2] / image_size
        kp = (np.concatenate([xy, kp[..., 2:]], axis=-1) if kp.shape[-1] > 2 else xy)
        clips = make_clips(kp.astype(np.float32), clip_len, stride)
        lift_sequence.clip_frames += clips.shape[0] * clip_len

        param = next(model.parameters())
        if use_kernels is None:
            use_kernels = param.dtype == torch.bfloat16
        x = torch.from_numpy(clips).to(param.device)
    with span("pose3d.lift_sequence.forward"), torch.inference_mode():
        if use_kernels and clip_len == model.clip_len and stblock.supports(model):
            out = stblock.temporal_forward_fused(model, x)
        else:
            out = model(x, use_kernels=use_kernels)
    with span("pose3d.lift_sequence.average"):
        out = out.float().cpu().numpy()  # (C, L, 17, 3)

        acc = np.zeros((t_total, 17, 3), np.float32)
        cnt = np.zeros((t_total, 1, 1), np.float32)
        for c, s in zip(out, clip_starts(t_total, clip_len, stride)):
            end = min(s + clip_len, t_total)
            acc[s:end] += c[: end - s]
            cnt[s:end] += 1.0
        assert cnt.min() >= 1.0, "internal: some frame covered by no clip"
        return acc / cnt


lift_sequence.videos = 0
lift_sequence.frames = 0
lift_sequence.clip_frames = 0


def lift_video_json(model, json_path, out_npy_path, image_size: float = 1000.0):
    """Consolidated video JSON -> lifted (T,17,3) poses, also saved as npy.
    A model of ``in_dim`` 3 is fed the JSON's per-joint confidences beside
    x and y."""
    kp2d, conf, _ = load_video_json(json_path)
    if model.in_dim == 3:
        kp2d = np.concatenate([kp2d, conf[..., None]], axis=-1)
    poses = lift_sequence(model, kp2d, image_size)
    save_mb_npy(poses, out_npy_path)
    return poses
