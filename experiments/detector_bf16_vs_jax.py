"""Is the bf16 PoseNet2D's distance from its f32 model bf16's own, or a
fault of the port? ``python3 experiments/detector_bf16_vs_jax.py
[--frames N]`` on the CPU, where both packages are installed.

Both packages' bf16 ``PoseNet2D`` run against their own f32 model on the
same weights and frames, at ``chip_smoke.py`` phase 25's configuration:
the default ResNet-50 ``PoseNet2D`` of the port from ``manual_seed(0)``,
its final 1x1 conv x40 (``DETECT_SCALE``), carried into the JAX package's
flax variables by its ``posenet2d_from_torch``; frames of 256 x 256
rendered by ``render_pose_frames`` from ``synthetic_h36m(N, seed=40)``
(noise from a generator seeded 41), as uint8 (x256, clamped at 255) and
back / 256, as ``detect_frames`` feeds them. The port's bf16 model is
its f32 one cast to bf16 (``pipeline.run.build_detector``'s bf16
checkpoint route; BatchNorm stays f32); the JAX one is ``PoseNet2D(dtype=
bfloat16)`` on the f32 parameters. Prints, for each package, the largest,
99.9th-percentile and mean |bf16 - f32| over the N x 34 coordinates in
[0, 1] units, the f32 coordinates' spread (std), the ratio of the port's
largest error to JAX's, and the two f32 models' largest difference.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pose3d_tpu_torch.data.synthetic import render_pose_frames, synthetic_h36m  # noqa: E402
from pose3d_tpu_torch.models.heads import PoseNet2D  # noqa: E402

SCALE = 40.0  # chip_smoke.DETECT_SCALE
SIZE = 256


def _errors(bf16: np.ndarray, f32: np.ndarray) -> str:
    err = np.abs(bf16 - f32).ravel()
    return (f"|bf16 - f32| max {err.max():.6g}, p99.9 {np.quantile(err, 0.999):.6g}, "
            f"mean {err.mean():.6g}; f32 spread {f32.std():.6g}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    torch.set_num_threads(8)

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from pose3d_tpu.interop.torch_weights import posenet2d_from_torch
    from pose3d_tpu.models.heads import PoseNet2D as FlaxPoseNet2D

    model = PoseNet2D(device="cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.final_layer.weight.mul_(SCALE)
    model.eval()
    kp, _ = synthetic_h36m(args.frames, seed=40)
    frames = render_pose_frames(torch.from_numpy(kp), torch.Generator().manual_seed(41),
                                size=SIZE)
    u8 = (frames * 256.0).clamp(max=255.0).to(torch.uint8)
    x = u8.float() / 256.0

    t0 = time.perf_counter()
    with torch.inference_mode():
        port32 = model(x).numpy()
        port16 = model.to(torch.bfloat16)(x).numpy()
    t_port = time.perf_counter() - t0

    sd = {k: v.float().numpy() for k, v in PoseNet2D(device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict().items()}
    sd["final_layer.weight"] = sd["final_layer.weight"] * SCALE
    x_np = x.numpy()
    template = jax.jit(lambda k: FlaxPoseNet2D().init({"params": k}, x_np[:1]))(
        jax.random.key(0))
    variables, _ = posenet2d_from_torch(template, sd)
    t0 = time.perf_counter()
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        net = FlaxPoseNet2D(dtype=dtype)
        out[name] = np.asarray(jax.jit(net.apply)(variables, x_np), np.float32)
    t_jax = time.perf_counter() - t0

    e_port = np.abs(port16 - port32).max()
    e_jax = np.abs(out["bf16"] - out["f32"]).max()
    print(f"PoseNet2D resnet50, {args.frames} frames of {SIZE}^2, final conv x{SCALE:g}, CPU "
          f"(port {t_port:.1f} s, JAX {t_jax:.1f} s)")
    print("port: " + _errors(port16, port32))
    print("JAX:  " + _errors(out["bf16"], out["f32"]))
    print(f"port's largest error over JAX's: {e_port / e_jax:.4g}; the f32 models' largest "
          f"difference {np.abs(port32 - out['f32']).max():.3g}")


if __name__ == "__main__":
    main()
