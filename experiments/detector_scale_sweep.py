"""How far does the bf16 PoseNet2D detector lie from the f32 one, at each
scale of its final conv? ``python3 experiments/detector_scale_sweep.py``
on one NVIDIA GPU.

A PoseNet2D from a seed gives near-uniform heatmaps: every coordinate
within a few 1e-3 of 0.47. ``chip_smoke.py`` phase 25 scales the final
1x1 conv so that the heatmaps peak and the coordinates spread (std over
frames and joints), then holds the bf16 detector to the f32 one. This
script measures both sides of that choice on phase 25's inputs: the
default ResNet-50 PoseNet2D from ``manual_seed(0)`` in f32 and in bf16
(TF32 off), 512 frames of 256 x 256 rendered by ``render_pose_frames``
from ``synthetic_h36m(512, seed=40)`` (noise from a CUDA generator seeded
41; the blob width and the noise as listed), the backbone and deconv head
run once per dtype, then for each scale the final conv (its weight x
scale, in the model's dtype) and the plain ``soft_argmax_2d``. Prints,
per (width, noise, scale): the f32 coordinates' std, and the largest,
99.9th-percentile and mean |bf16 - f32| over the 512 x 34 coordinates in
[0, 1] units; first the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pose3d_tpu_torch.data.synthetic import render_pose_frames, synthetic_h36m  # noqa: E402
from pose3d_tpu_torch.models.heads import PoseNet2D  # noqa: E402
from pose3d_tpu_torch.ops.heatmap import soft_argmax_2d  # noqa: E402

FRAMES, BATCH = 512, 64
SCALES = (8, 16, 24, 32, 40, 48, 64)
RENDERS = ((2.5, 0.12), (6.0, 0.12), (10.0, 0.12), (6.0, 0.0))  # (blob width px, noise)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("detector_scale_sweep: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = PoseNet2D(device="cpu").init_weights(torch.Generator().manual_seed(0)).state_dict()
    models = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = PoseNet2D(device="cpu", dtype=dtype)
        m.load_state_dict(base)
        models[dtype] = m.cuda().eval()
    kp, _ = synthetic_h36m(FRAMES, seed=40)
    kp = torch.from_numpy(kp).cuda()
    with torch.inference_mode():
        for sigma, noise in RENDERS:
            frames = render_pose_frames(kp, torch.Generator("cuda").manual_seed(41),
                                        sigma=sigma, noise=noise)
            u8 = (frames * 255.0).round().to(torch.uint8)
            feats = {dtype: [m.deconv_layers(m.preact(
                (u8[c:c + BATCH].float() / 256.0).permute(0, 3, 1, 2)))
                for c in range(0, FRAMES, BATCH)] for dtype, m in models.items()}
            for scale in SCALES:
                coords = {}
                for dtype, m in models.items():
                    w = m.final_layer.weight * scale
                    coords[dtype] = torch.cat([
                        soft_argmax_2d(F.conv2d(f, w, m.final_layer.bias), 17, *f.shape[2:])
                        for f in feats[dtype]])
                err = (coords[torch.bfloat16] - coords[torch.float32]).abs().flatten()
                print(f"width {sigma} noise {noise} scale {scale}: spread "
                      f"{coords[torch.float32].std().item():.4f}, |bf16 - f32| max "
                      f"{err.max().item():.4f} p99.9 {err.quantile(0.999).item():.4f} mean "
                      f"{err.mean().item():.5f}", flush=True)


if __name__ == "__main__":
    main()
