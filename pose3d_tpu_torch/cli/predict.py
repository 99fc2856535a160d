"""Inference CLI, 2D keypoints -> 3D with a trained checkpoint of the
port: the port of ``pose3d_tpu/cli/predict.py``.

- ``--model vit | martinez | ae``: a phase-1 checkpoint
  (``cli/train_lift.py``) lifts each frame, in chunks of ``--batch_size``
  (a last chunk shorter than it, after a first whole one, is padded).
- ``--model temporal``: a checkpoint of ``cli/train_temporal.py`` lifts the
  sequence in clips (``pipeline.lift.lift_sequence``) as an f32 model,
  which keeps the module route, as the JAX CLI does. The architecture
  comes from the state dict's shapes, the head count from ``--heads``,
  else the checkpoint's ``.meta.json``, else 8.

The input is an (N, 17, 2) ``.npy`` or a consolidated video JSON, whose
pixel coordinates are divided by ``--image_size``; the output is a
float32 (N, 17, 3) ``.npy``. The model runs on the card unless ``--cpu``
is given; without CUDA and without ``--cpu`` it raises.

Usage:
  python -m pose3d_tpu_torch.cli.predict --checkpoint lift_run --model vit \\
      --input kp2d.npy --output kp3d.npy
  python -m pose3d_tpu_torch.cli.predict --checkpoint t1 --model temporal \\
      --input video.json --output MB_npy/video.npy
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from pose3d_tpu_torch.cli.train_lift import build_lifter
from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.pipeline.keypoints import load_video_json
from pose3d_tpu_torch.pipeline.lift import lift_sequence
from pose3d_tpu_torch.train import checkpoint as ckpt


def temporal_from_checkpoint(log_dir, run_name: str, heads: int | None = None, *,
                             device) -> TemporalLifter:
    """The f32 ``TemporalLifter`` of a checkpoint, in eval mode on
    ``device``: its widths read from the state dict, ``heads`` (which no
    shape carries) from the argument, the ``.meta.json`` or 8."""
    sd = ckpt.peek_params(log_dir, run_name)
    if heads is None:
        heads = ckpt.load_meta(log_dir, run_name).get("heads", 8)
    model = TemporalLifter(
        n_joints=sd["spatial_pe"].shape[2], in_dim=sd["embed.weight"].shape[1],
        out_dim=sd["head.2.weight"].shape[0], clip_len=sd["temporal_pe"].shape[1],
        hidden=sd["embed.weight"].shape[0],
        n_blocks=len({k.split(".")[1] for k in sd if k.startswith("blocks.")}),
        heads=heads, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def lift_frames(model, kp2d: np.ndarray, batch_size: int) -> np.ndarray:
    """(N, 17, 2) -> (N, 17, 3) float32 through a per-frame lifter on its
    device, ``batch_size`` frames a call; a last chunk shorter than it is
    padded with zeros when it follows a whole one."""
    device = next(model.parameters()).device
    chunks = []
    for s in range(0, len(kp2d), batch_size):
        chunk = kp2d[s:s + batch_size]
        pad = batch_size - len(chunk) if s > 0 else 0
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, 17, 2), np.float32)])
        with torch.inference_mode():
            out = model(torch.from_numpy(chunk).to(device)).float().cpu().numpy()
        out = out.reshape(-1, 17, 3)
        chunks.append(out[: len(out) - pad])
    return np.concatenate(chunks)


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model", default="vit", choices=["vit", "martinez", "ae", "temporal"])
    p.add_argument("--input", required=True, help="(N,17,2) npy, or a pipeline video JSON")
    p.add_argument("--output", required=True)
    p.add_argument("--log_dir", default="./logs")
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--image_size", type=float, default=1000.0,
                   help="pixel scale when reading a video JSON")
    p.add_argument("--heads", type=int, default=None,
                   help="attention heads of a temporal checkpoint; default: its "
                        ".meta.json, else 8")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")

    inp = pathlib.Path(args.input)
    if inp.suffix == ".json":
        kp2d = load_video_json(inp)[0] / args.image_size
    else:
        kp2d = np.load(inp).astype(np.float32)
    if kp2d.ndim != 3 or kp2d.shape[1:] != (17, 2):
        raise ValueError(f"{inp}: shape {kp2d.shape}, expected (N, 17, 2)")

    if args.model == "temporal":
        model = temporal_from_checkpoint(args.log_dir, args.checkpoint, args.heads,
                                         device=device)
        poses = lift_sequence(model, kp2d * args.image_size, image_size=args.image_size)
    else:
        model = ckpt.restore_params(args.log_dir, args.checkpoint, build_lifter(args.model))
        poses = lift_frames(model.to(device).eval(), kp2d, args.batch_size)

    out_path = pathlib.Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    poses = poses.astype(np.float32)
    np.save(out_path, poses)
    print(f"lifted {poses.shape} -> {out_path}")
    return poses


if __name__ == "__main__":
    main()
