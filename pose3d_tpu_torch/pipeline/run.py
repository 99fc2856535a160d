"""Video -> 2D keypoints -> 3D poses: the port of
``pose3d_tpu/pipeline/run.py`` (the reference's phase 2,
``phase2_opp_mb/run.py:453-472``).

The directory layout is the reference's: ``raw_videos/<video>`` ->
``ffmpeg_frames/<video>/%04d.jpg`` -> ``opp_outputs/<video>/jsons_force/``
(one JSON a frame) -> ``final_json_outputs/<video>.json`` ->
``MB_npy/<video>.npy``. The video is decoded in the process, the detector
takes the whole frame directory in one call, and the temporal lifter
replaces the reference's hand-off to MotionBERT. The ``posenet2d``
detector and the lifter run on the card unless ``--cpu`` is given; the
lifter computes in bf16, so ``lift_video_json`` takes the kernels
(``ops/stblock.py`` for clips of 243 frames, ``ops/attention.py`` for a
shorter video). Checkpoints are the port's ``torch.save`` ones
(``train/checkpoint.py``); a missing one gives a fresh init from seed 0.
``--render`` draws the detections over the frames into
``opp_2d_frames/<video>/out.mp4`` and, where poses were lifted, the 3D
skeletons into ``MB_3d_frames/<video>/out.mp4`` (``utils/visualize.py``;
needs matplotlib and cv2).

Usage:
  python -m pose3d_tpu_torch.pipeline.run --video my.mp4 --root ./videos \\
      --detector posenet2d --detector_checkpoint det_run \\
      --lifter_checkpoint temporal_run --fps 10 [--render] [--cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from pose3d_tpu_torch.models.heads import PoseNet2D
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.pipeline import keypoints as kp_lib
from pose3d_tpu_torch.pipeline import video as video_lib
from pose3d_tpu_torch.pipeline.detector import (MockDetector, OpenPifPafDetector,
                                                PoseNet2DDetector)
from pose3d_tpu_torch.pipeline.lift import lift_video_json
from pose3d_tpu_torch.train import checkpoint as ckpt

SEED = 0  # a fresh init's weights, where no checkpoint is found


def process_video(video: str, root, detector, lifter=None, fps: float = 10.0,
                  render: bool = False, already_h36m: bool = False):
    """Run the stages for one video under ``root``: extract the frames of
    ``raw_videos/<video>`` where it exists (else read them from
    ``ffmpeg_frames/<video>/``), detect, merge, and lift with ``lifter`` (a
    ``TemporalLifter`` on its device) where one is given; with ``render``,
    the 2D and 3D videos. Returns the (T, 17, 3) poses, or None without a
    lifter."""
    root = pathlib.Path(root)
    frames_dir = root / "ffmpeg_frames" / video
    jsons_dir = root / "opp_outputs" / video / "jsons_force"
    final_json = root / "final_json_outputs" / f"{video}.json"
    npy_out = root / "MB_npy" / f"{video}.npy"

    if (root / "raw_videos" / video).exists():
        n = video_lib.extract_frames(root / "raw_videos" / video, frames_dir, fps)
        print(f"frames: {n}")
    if not frames_dir.exists():
        raise FileNotFoundError(f"no frames at {frames_dir}")

    detector.detect_dir(frames_dir, jsons_dir)
    records = kp_lib.save_to_json(jsons_dir, final_json, already_h36m)
    print(f"detections: {len(records)} frames -> {final_json}")

    poses = None
    if lifter is not None:
        poses = lift_video_json(lifter, final_json, npy_out)
        print(f"lifted: {poses.shape} -> {npy_out}")

    if render:
        from pose3d_tpu_torch.utils.visualize import render_2d_video, render_3d_video

        render_2d_video(final_json, frames_dir, root / "opp_2d_frames" / video / "out.mp4", fps)
        if poses is not None:
            # the reference's display convention (run.py:305-352): camera ->
            # global by the S1 camera-2 quaternion (:312-316, :336), then
            # x2.8 (:343); no root-centring (commented out there, :339-341)
            render_3d_video(poses, root / "MB_3d_frames" / video / "out.mp4", fps, scale=2.8,
                            to_global=True)
    return poses


def build_detector(log_dir, run_name: str | None, device) -> PoseNet2DDetector:
    """The ``PoseNet2D`` detector of a ``torch.save`` checkpoint (its
    architecture and dtype from the ``.meta.json``: ``architecture``,
    default resnet50; ``bf16``, default f32), or a fresh init from ``SEED``
    where there is none, in eval mode on ``device``."""
    meta = ckpt.load_meta(log_dir, run_name) if run_name else {}
    model = PoseNet2D(meta.get("architecture", "resnet50"), device="cpu",
                      dtype=torch.bfloat16 if meta.get("bf16") else torch.float32)
    model.init_weights(torch.Generator().manual_seed(SEED))
    if run_name and ckpt.exists(log_dir, run_name):
        ckpt.restore_params(log_dir, run_name, model)
        print(f"detector restored from {run_name} ({meta.get('architecture')}, "
              f"eval_px_err {meta.get('eval_px_err', '?')})")
    elif run_name:
        print(f"detector checkpoint {run_name} not found; using fresh init")
    return PoseNet2DDetector(model.to(device).eval())


def build_lifter(log_dir, run_name: str, device):
    """The default ``TemporalLifter`` in bf16 (the serving dtype, which takes
    the kernels), holding a ``torch.save`` checkpoint's weights, or a fresh
    init from ``SEED`` where there is none, in eval mode on ``device``."""
    lifter = TemporalLifter(device="cpu")
    lifter.init_weights(torch.Generator().manual_seed(SEED))
    if ckpt.exists(log_dir, run_name):
        ckpt.restore_params(log_dir, run_name, lifter)
        print(f"lifter restored from {run_name}")
    else:
        print("lifter checkpoint not found; using fresh init")
    return lifter.to(device=device, dtype=torch.bfloat16).eval()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run the models on the CPU")
    p.add_argument("--video", required=True)
    p.add_argument("--root", default="./videos")
    p.add_argument("--detector", default="mock", choices=["mock", "openpifpaf", "posenet2d"])
    p.add_argument("--detector_checkpoint", default=None,
                   help="run name of a PoseNet2D checkpoint under --log_dir; without it "
                        "the posenet2d route is a fresh init")
    p.add_argument("--lifter_checkpoint", default=None,
                   help="run name of a cli.train_temporal checkpoint; without it nothing "
                        "is lifted")
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--render", action="store_true",
                   help="render the 2D detections and the 3D poses to mp4s")
    args = p.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")

    already_h36m = False
    if args.detector == "mock":
        detector = MockDetector()
    elif args.detector == "openpifpaf":
        detector = OpenPifPafDetector()
    else:
        detector = build_detector(args.log_dir, args.detector_checkpoint, device)
        already_h36m = True
    lifter = (build_lifter(args.log_dir, args.lifter_checkpoint, device)
              if args.lifter_checkpoint else None)
    process_video(args.video, args.root, detector, lifter, args.fps, args.render,
                  already_h36m)
    print("___DONE___")


if __name__ == "__main__":
    main()
