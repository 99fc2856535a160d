"""End-to-end walkthrough of the PyTorch port (``pose3d_tpu_torch``): the
steps of ``examples/end_to_end.py`` on the port, hermetically (synthetic
data, a mock detector and a rendered video), on the card or with
``--cpu`` at toy sizes:

  1. train a phase-1 lifter          (reference: phase1 train_1.py)
  2. train the projector             (reference: phase5 train_project.py)
  3. phase-5 consistency loop        (reference: phase5 train_5.py)
  4. direct image->3D                (reference: phase3 train_3.py)
  5. temporal sequence lifter        (reference: external MotionBERT)
  6. video -> keypoints -> 3D, with the mock detector, then with a
     trained PoseNet2D on a rendered video (reference: phase2 run.py)
  7. serve the lifter                (LifterService)
  8. data parallelism: 2 spawned ranks (``gloo`` with ``--cpu``; on the
     card ``nccl`` where there are two GPUs, else ``gloo`` sharing one),
     DP serving and one DP temporal training step (the fused training
     kernels on the card), every rank's answers and parameters equal

Usage:  python examples/end_to_end_torch.py [--cpu] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile
import traceback

import numpy as np

# allow running straight from a checkout: examples/.. is the repo root
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

WORLD = 2
DP_CLIP_LEN = 12


def dp_rank(rank: int, device_type: str, backend: str, logs: str, kp2d: np.ndarray,
            clips: tuple, out_dir: str) -> None:
    """Step 8 on one rank: the lifter checkpoint served over the mesh, one
    DP temporal step on this rank's shard of ``clips``; saves (result,
    error) to ``out_dir``."""
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.ops.stblock import supports
    from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
    from pose3d_tpu_torch.parallel import mesh as M
    from pose3d_tpu_torch.serving import LifterService
    from pose3d_tpu_torch.train import checkpoint as ckpt
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    result, error = None, None
    try:
        device = M.init_distributed(backend, device_type=device_type,
                                    init_method=f"file://{out_dir}/rdzv")
        mesh = M.make_mesh()
        svc = LifterService(JointTransformerLifter(device="cpu"), ckpt.peek_params(logs, "lifter"),
                            device=device, max_batch=512, min_bucket=64, mesh=mesh)
        answer = svc.lift(kp2d)

        model = TemporalLifter(clip_len=DP_CLIP_LEN, n_blocks=1, device="cpu")
        model = model.init_weights(torch.Generator().manual_seed(3)).to(device)
        fused = device.type == "cuda" and supports(model)
        state = create_train_state(model, lr=1e-3,
                                   apply=temporal_train_forward_fused if fused else None)
        y1, y2 = (torch.from_numpy(a).to(device) for a in M.shard_batch(clips, mesh))
        m = make_dp_lifter_train_step(mesh)(state, y1, y2)
        result = {"answer": answer, "loss": m["loss"].item(), "fused": fused,
                  "params": {k: v.cpu() for k, v in model.state_dict().items()}}
    except BaseException:
        error = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.save((result, error), f"{out_dir}/rank{rank}.pt")


def run_dp(device_type: str, logs: str, work: pathlib.Path, rng) -> None:
    n_gpu = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = "nccl" if n_gpu >= WORLD else "gloo"
    kp2d = rng.random((100, 17, 2)).astype(np.float32)
    clips = (rng.random((2 * WORLD, DP_CLIP_LEN, 17, 2)).astype(np.float32),
             (rng.random((2 * WORLD, DP_CLIP_LEN, 17, 3)) - 0.5).astype(np.float32))
    out = work / "dp"
    out.mkdir()
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, device_type, backend, logs, kp2d, clips,
                                               str(out))) for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            raise SystemExit("a rank is still running after 600 s")
    res = []
    for r in range(WORLD):
        result, error = torch.load(out / f"rank{r}.pt", weights_only=False)
        if error:
            raise SystemExit(f"rank {r} failed:\n{error}")
        res.append(result)
    if not all(np.array_equal(r["answer"], res[0]["answer"]) for r in res):
        raise SystemExit("the ranks' served answers differ")
    if not all(torch.equal(v, r["params"][k]) for r in res for k, v in res[0]["params"].items()):
        raise SystemExit("the ranks' parameters differ after the DP step")
    print(f"DP serving over {WORLD} ranks ({backend}, {device_type}): "
          f"{res[0]['answer'].shape}, every rank the whole answer")
    print(f"DP temporal train step over {WORLD} ranks ({'fused kernels' if res[0]['fused'] else 'module'}): "
          f"loss {res[0]['loss']:.4f}, parameters equal on every rank")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, at toy sizes")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --cpu to run on the CPU")
    dev = "cpu" if args.cpu else "cuda"
    small = args.cpu  # toy sizes on the CPU
    work = pathlib.Path(args.workdir or tempfile.mkdtemp(prefix="pose3d_torch_"))
    logs = str(work / "logs")
    print(f"== workdir {work}, device {dev} ==")

    from pose3d_tpu_torch.config import (DataConfig, DetectorConfig, DirectConfig, LiftConfig,
                                         LoopConfig, TemporalConfig)

    data = DataConfig(synthetic_frames=512 if small else 2048)

    print("\n[1/8] phase-1 lifter")
    from pose3d_tpu_torch.cli.train_lift import train as train_lift

    train_lift(LiftConfig(n_epochs=1 if small else 3, batch_size=128, run_name="lifter",
                          log_dir=logs, data=data, device=dev))

    print("\n[2/8] projector")
    from pose3d_tpu_torch.cli.train_project import train as train_project

    train_project(LiftConfig(n_epochs=1 if small else 2, batch_size=128, run_name="projector",
                             log_dir=logs, data=data, device=dev))

    print("\n[3/8] phase-5 consistency loop (triangle + flip + project)")
    from pose3d_tpu_torch.cli.train_loop import train as train_loop

    train_loop(LoopConfig(n_epochs=1, batch_size=4 if small else 8, run_name="loop",
                          log_dir=logs, architecture="resnet18", image_size=64, bf16=False,
                          triangle=True, flip=True, project=True, lifter_checkpoint="lifter",
                          projector_checkpoint="projector", device=dev,
                          data=DataConfig(synthetic_frames=16 if small else 64)))

    print("\n[4/8] direct image->3D (phase 3)")
    from pose3d_tpu_torch.cli.train_direct import infer, train as train_direct

    dcfg = DirectConfig(architecture="resnet18", n_epochs=1 if small else 2,
                        batch_size=4 if small else 16, chunk_steps=2, run_name="direct",
                        log_dir=logs, image_size=64, bf16=False, device=dev,
                        data=DataConfig(synthetic_frames=16 if small else 128))
    train_direct(dcfg)
    infer(dcfg)

    print("\n[5/8] temporal sequence lifter (243-frame capability, small here)")
    from pose3d_tpu_torch.cli.train_temporal import train as train_temporal

    tfields = {"clip_len": 16, "hidden": 64, "n_blocks": 2 if not small else 1, "heads": 4}
    train_temporal(TemporalConfig(**tfields, batch_size=8, n_epochs=1 if small else 2,
                                  run_name="temporal", log_dir=logs, device=dev,
                                  data=DataConfig(synthetic_frames=256 if small else 512)))

    print("\n[6/8] video -> keypoints -> 3D pipeline")
    from pose3d_tpu_torch.data.synthetic import render_pose_frames, synthetic_h36m
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.pipeline.detector import MockDetector, PoseNet2DDetector
    from pose3d_tpu_torch.pipeline.keypoints import load_video_json
    from pose3d_tpu_torch.pipeline.run import process_video
    from pose3d_tpu_torch.pipeline.video import write_video
    from pose3d_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(0)
    videos = work / "videos"
    (videos / "raw_videos").mkdir(parents=True, exist_ok=True)
    write_video(iter((rng.random((20, 64, 64, 3)) * 255).astype(np.uint8)),
                videos / "raw_videos" / "demo.mp4", fps=10)
    lifter = ckpt.restore_params(logs, "temporal", TemporalLifter(**tfields, device="cpu"))
    lifter = lifter.to(dev).eval()
    poses = process_video("demo.mp4", videos, MockDetector(), lifter, fps=100)
    print(f"pipeline output: {poses.shape} -> {videos / 'MB_npy' / 'demo.mp4.npy'}")

    print("\n[6b/8] detection by a trained PoseNet2D on a rendered video")
    from pose3d_tpu_torch.cli.train_detector import train as train_detector

    det_state, det_px = train_detector(DetectorConfig(
        run_name="detector", log_dir=logs, architecture="resnet18",
        n_steps=8 if small else 240, chunk_steps=4 if small else 8, batch_size=4 if small else 8,
        image_size=64 if small else 256, n_train=64 if small else 512,
        n_eval=8 if small else 64, bf16=not small, device=dev))
    size = 64 if small else 256
    gt2d, gt3d = synthetic_h36m(20, seed=5)
    frames = render_pose_frames(torch.from_numpy(gt2d).to(dev),
                                torch.Generator(dev).manual_seed(5), size=size)
    write_video(iter((frames.float().cpu().numpy() * 255).astype(np.uint8)),
                videos / "raw_videos" / "skel.mp4", fps=10)
    detector = PoseNet2DDetector(det_state.model.eval(), image_size=size, batch_size=8)
    poses = process_video("skel.mp4", videos, detector, lifter, fps=100, already_h36m=True)
    det2d, _, _ = load_video_json(videos / "final_json_outputs" / "skel.mp4.json")
    det_err_px = float(np.linalg.norm(det2d / 1000.0 - gt2d, axis=-1).mean() * size)
    mpjpe_mm = float(np.linalg.norm((poses - poses[:, :1]) - (gt3d - gt3d[:, :1]),
                                    axis=-1).mean() * 1000)
    print(f"pipeline accuracy: detection {det_err_px:.1f} px @{size} (trained to {det_px:.1f}), "
          f"lifted MPJPE {mpjpe_mm:.1f} mm vs the synthetic ground truth")

    print("\n[7/8] serving")
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter
    from pose3d_tpu_torch.serving import LifterService

    svc = LifterService(JointTransformerLifter(device="cpu"), ckpt.peek_params(logs, "lifter"),
                        device=dev, max_batch=512, min_bucket=64)
    out = svc.lift(rng.random((300, 17, 2)).astype(np.float32))
    print(f"served {out.shape}; all artifacts under {work}")

    print("\n[8/8] data parallelism (spawned ranks)")
    run_dp(dev, logs, work, rng)
    print("\n== DONE ==")


if __name__ == "__main__":
    sys.exit(main())
