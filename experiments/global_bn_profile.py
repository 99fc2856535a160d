"""Where does the global-BN direct step spend its host time?
``python3 experiments/global_bn_profile.py`` on one NVIDIA GPU.

Joins a world of one ``nccl`` rank in this process and builds the
default ResNet-50 ``PoseNet3D`` on the NHWC route with its plain decode
(no kernel of the port), f32 master weights on the card, bf16 compute
(``bf16_apply``), B = 64 uint8 frames of 256 x 256. Times the Adam step
(``make_direct_train_step``) by CUDA events with cuDNN's batch norm and
with every BatchNorm forced through the global-BN Function over the one
rank (as ``chip_smoke.py`` phase 28 does); then, with torch.profiler on
the CPU, the ops of the forced step by self CPU time a step; then the
host time of one ``all_reduce`` of a small tensor, and of one BatchNorm's
forward and backward on a small input, each way. Prints the card's name
and power limit first.
"""

from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pose3d_tpu_torch.data.synthetic import synthetic_frames, synthetic_h36m  # noqa: E402
from pose3d_tpu_torch.models.heads import PoseNet3D  # noqa: E402
from pose3d_tpu_torch.models.norm import (F32BatchNorm2d, _F32Norm,  # noqa: E402
                                          sync_batch_norm)
from pose3d_tpu_torch.parallel import mesh as PM  # noqa: E402
from pose3d_tpu_torch.train.image_steps import bf16_apply, make_direct_train_step  # noqa: E402
from pose3d_tpu_torch.train.state import create_train_state  # noqa: E402

B, SIZE, STEPS = 64, 256, 10


def force_global(model, mesh):
    sync_batch_norm(model, mesh)
    for m in model.modules():
        if isinstance(m, _F32Norm):
            m.process_group = PM.data_group(mesh)


def event_ms(fn, n=STEPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def host_us(fn, n=200) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def main() -> None:
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    PM.init_distributed("nccl", device_type="cuda")
    mesh = PM.make_mesh()
    try:
        model = PoseNet3D(device="cpu", return_heatmap=False).init_weights(
            torch.Generator().manual_seed(0))
        model = model.to("cuda").train()
        frames = torch.from_numpy((synthetic_frames(B, SIZE, seed=1) * 256).astype(np.uint8))
        _, kp3d = synthetic_h36m(B, seed=1)
        frames, kp3d = frames.to("cuda"), torch.from_numpy(kp3d - kp3d[:, :1]).to("cuda")
        state = create_train_state(model, lr=1e-3, optimizer="adam", weight_decay=1e-8,
                                   apply=bf16_apply)
        step = make_direct_train_step("mse")
        cudnn = event_ms(lambda: step(state, frames, kp3d))
        force_global(model, mesh)
        forced = event_ms(lambda: step(state, frames, kp3d))
        print(f"direct step bf16 B={B} NHWC plain: cuDNN's batch norm {cudnn:.4f} ms, global BN "
              f"forced over one rank {forced:.4f} ms (CUDA events, {STEPS} steps a run)")

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(STEPS):
                step(state, frames, kp3d)
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
        print("forced step, self CPU ms a step by op:")
        for e in rows[:20]:
            print(f"  {e.key}: {e.self_cpu_time_total / STEPS / 1e3:.3f} ms, "
                  f"{e.count / STEPS:.0f} calls")

        group = PM.data_group(mesh)
        small = torch.zeros(3 * 256 + 1, device="cuda")
        print(f"host us a call: all_reduce of {small.numel()} f32 "
              f"{host_us(lambda: dist.all_reduce(small, group=group)):.1f}")
        x = torch.randn(8, 256, 16, 16, device="cuda").bfloat16().contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        for name in ("cudnn", "global"):
            bn = F32BatchNorm2d(256, device="cuda").train()
            if name == "global":
                force_global(bn, mesh)
            print(f"host us a call: {name} BatchNorm forward {host_us(lambda: bn(x)):.1f}, "
                  f"forward and backward {host_us(lambda: bn(x).sum().backward()):.1f}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
