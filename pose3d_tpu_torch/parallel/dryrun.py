"""The multi-process dry run: the port of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` spawns ``n`` ``gloo`` ranks, all on cuda:0
(``nccl`` takes one device a rank), or on the CPU with ``device="cpu"``,
and each runs one train step of JAX's seven stages, at JAX's sizes, over
a mesh of the world:

1. ``MartinezLifter`` (hidden 1024, 2 stages), global BatchNorm and its
   wide layers cut over the model axis (``parallel/sharding.py``), on an
   (n/2) x 2 mesh when n is even and at least 4, else n x 1; batch 8 a
   data rank;
2. the temporal lifter (hidden 64, one block, 2 heads, clips of 8 frames
   a model rank) with sequence parallelism: ``activation_spec=("data",
   "model", None, None)`` on stage 1's mesh, the batch over the data axis
   and each clip's frames over the model axis (``sequence_parallel``);
3. the global-BatchNorm direct step (``PoseNet3D``, ResNet-18, depth 8,
   32 x 32, 2 frames a rank);
4. the SMPL-IK step (``HybrIKPose``: ResNet-18, depth 8, 64 x 64, the
   300-vertex synthetic body; Adam 3e-4), global BatchNorm;
5. the phase-5 loop step (both image models global-BN, the frozen ViT
   lifter and projector, ``sep`` triangle loss with flip), then its
   plateau step;
6. the fused temporal train step (clips of 12, one block) under
   ``make_dp_lifter_train_step``: on the card rows 8a-9b's kernels;
7. the fused conv + decode step (``PoseNet3D(fuse_final_conv=True)``, 64
   x 64, one frame a rank) under ``make_dp_direct_train_step``: on the
   card, in bf16, rows 13a and 13b's kernels.

Rank 0's line for each stage (``dryrun_multichip ok: ...`` with a finite
loss) is printed by the caller's process. A rank that fails or hangs ends
the run with an error. ``run_ranks`` spawns the ranks; the multi-process
checks of ``chip_smoke.py`` and the tests spawn theirs with it too.

    python -m pose3d_tpu_torch.parallel.dryrun 4 [--cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DEADLINE_S = 600.0


def _kernel_counts() -> dict[str, int]:
    """{wrapper: launches} of every kernel wrapper of ``ops/`` in this
    process."""
    from pose3d_tpu_torch.ops import (attention, conv_decode, flash_attention, lifter, martinez,
                                      softargmax, stblock, stblock_train)

    return {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": f.launches
            for mod in (attention, conv_decode, flash_attention, lifter, martinez, softargmax,
                        stblock, stblock_train)
            for name, f in vars(mod).items() if callable(f) and hasattr(f, "launches")}


def _stages(n: int, device: torch.device) -> list[str]:
    """The seven stages on this rank; rank 0's lines."""
    from pose3d_tpu_torch.data.synthetic import synthetic_h36m
    from pose3d_tpu_torch.models.heads import PoseNet2D, PoseNet3D
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter, MartinezLifter
    from pose3d_tpu_torch.models.norm import sync_batch_norm
    from pose3d_tpu_torch.models.smpl import synthetic_model
    from pose3d_tpu_torch.models.smpl_pose import HybrIKPose, PoseSMPLNet
    from pose3d_tpu_torch.models.temporal import TemporalLifter, make_clips
    from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
    from pose3d_tpu_torch.parallel.mesh import data_rank, make_mesh, shard_batch, shard_seed
    from pose3d_tpu_torch.parallel.sharding import sequence_parallel, shard_params
    from pose3d_tpu_torch.train.image_steps import (bf16_apply, make_direct_train_step,
                                                    make_dp_direct_train_step)
    from pose3d_tpu_torch.train.loop_steps import (LoopState, freeze, loop_plateau_step,
                                                   make_loop_train_step)
    from pose3d_tpu_torch.train.smpl_steps import make_hybrik_train_step
    from pose3d_tpu_torch.train.state import create_train_state
    from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step, make_lifter_train_step

    lines = []

    def put(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    def seeded(model, seed):  # the same weights on every rank, made on the CPU
        return model.init_weights(torch.Generator().manual_seed(seed)).to(device)

    def run(mesh, seed, fn):  # dropout drawn from the data rank's stream
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   device_type="cuda"):
            torch.manual_seed(shard_seed(seed, data_rank(mesh)))
            return fn()

    def done(what, loss):
        loss = float(loss)
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite {what} loss {loss}")
        return loss

    # stage 1: DP x TP Martinez, global BatchNorm
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n // n_model, n_model)
    kp2d, kp3d = synthetic_h36m(8 * (n // n_model))
    y1, y2 = shard_batch(put(kp2d, kp3d - kp3d[:, :1]), mesh)
    model = shard_params(sync_batch_norm(seeded(MartinezLifter(device="cpu"), 0), mesh), mesh)
    state = create_train_state(model, lr=1e-3)
    m = run(mesh, 1, lambda: make_lifter_train_step("mse", mesh)(state, y1, y2))
    state.plateau.step(m["loss"].item())
    lines.append(f"dryrun_multichip ok: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                 f"loss={done('martinez', m['loss']):.5f} (dp x tp)")

    # stage 2: the temporal lifter, dp x sp
    clip_len = 8 * n_model
    kp2d, kp3d = synthetic_h36m(clip_len * (n // n_model) * 2)
    c2, c3 = shard_batch(put(make_clips(kp2d, clip_len),
                             make_clips(kp3d - kp3d[:, :1], clip_len)), mesh)
    lifter = sequence_parallel(seeded(TemporalLifter(
        clip_len=clip_len, hidden=64, n_blocks=1, heads=2,
        activation_spec=("data", "model", None, None), device="cpu"), 2), mesh)
    state = create_train_state(lifter, lr=1e-3)
    m = make_lifter_train_step("mse", mesh)(state, c2, c3)
    lines.append(f"dryrun_multichip ok: temporal dp x sp loss={done('temporal', m['loss']):.5f}")

    dp = make_mesh(n, 1)
    # stage 3: the direct model, global BatchNorm
    rng = np.random.default_rng(0)
    frames, kps = put(rng.random((2 * n, 32, 32, 3), np.float32),
                      rng.random((2 * n, 17, 3), np.float32) - 0.5)
    net = seeded(PoseNet3D("resnet18", depth=8, return_heatmap=False, use_kernels=False,
                           device="cpu"), 4)
    state = create_train_state(sync_batch_norm(net, dp), lr=1e-3)
    m = make_direct_train_step(mesh=dp)(state, *shard_batch((frames, kps), dp))
    lines.append(f"dryrun_multichip ok: image dp (global-BN R18+soft-argmax) "
                 f"loss={done('image', m['loss']):.5f}")

    # stage 4: the SMPL-IK model
    b = 2 * n
    cam = (np.broadcast_to(np.eye(2, 3), (b, 2, 3)),
           np.broadcast_to(np.diag([1e-3, 1e-3, 1.0]), (b, 3, 3)),
           np.tile([[0.0, 0.0, 3000.0]], (b, 1)), np.full((b, 1), 2200.0))
    arrays = put(rng.random((b, 64, 64, 3), np.float32), *(a.astype(np.float32) for a in cam),
                 rng.uniform(-0.4, 0.4, (b, 29, 3)).astype(np.float32),
                 rng.uniform(-0.3, 0.3, (b, 17, 3)).astype(np.float32))
    sframes, *scam, uvd_gt, xyz_gt = shard_batch(arrays, dp)
    assembly = HybrIKPose(PoseSMPLNet("resnet18", depth=8, device="cpu").init_weights(
        torch.Generator().manual_seed(6)), synthetic_model(300, seed=1)).to(device)
    state = create_train_state(sync_batch_norm(assembly, dp), lr=3e-4, optimizer="adam")
    m = make_hybrik_train_step(mesh=dp)(state, sframes, tuple(scam), uvd_gt, xyz_gt, 7)
    lines.append(f"dryrun_multichip ok: smpl-ik dp (R18+IK+LBS) "
                 f"loss={done('smpl-ik', m['loss']):.5f}")

    # stage 5: the consistency loop
    limg, ly1, ly2 = put(rng.random((2 * n, 32, 32, 3), np.float32),
                         rng.random((2 * n, 17, 2), np.float32),
                         rng.random((2 * n, 17, 3), np.float32) - 0.5)
    vit = {"hidden": 64, "n_blocks": 1, "heads": 2, "device": "cpu"}
    lstate = LoopState(
        net2d=create_train_state(sync_batch_norm(seeded(PoseNet2D("resnet18", device="cpu"), 8),
                                                 dp), lr=5e-4),
        net3d=create_train_state(sync_batch_norm(seeded(PoseNet3D(
            "resnet18", depth=8, use_kernels=False, device="cpu"), 9), dp), lr=5e-4),
        lifter=freeze(seeded(JointTransformerLifter(**vit), 10)),
        projector=freeze(seeded(JointTransformerLifter(in_dim=3, out_dim=2, **vit), 11)))
    step = make_loop_train_step(triangle=True, flip=True, project=True, triangle_mode="sep",
                                mesh=dp)
    m = step(lstate, *shard_batch((limg, ly1, ly2), dp))
    loop_plateau_step(lstate, m["loss"].item())
    lines.append(f"dryrun_multichip ok: consistency-loop dp (2D+3D+frozen lifter/projector, "
                 f"triangle+flip) loss={done('loop', m['loss']):.5f}")

    # stage 6: the fused temporal train step
    fy1, fy2 = put(np.random.default_rng(14).random((n, 12, 17, 2), np.float32),
                   np.random.default_rng(15).random((n, 12, 17, 3), np.float32) - 0.5)
    fmodel = seeded(TemporalLifter(clip_len=12, n_blocks=1, device="cpu"), 13)
    state = create_train_state(fmodel, lr=1e-3, apply=temporal_train_forward_fused)
    m = run(dp, 16, lambda: make_dp_lifter_train_step(dp)(state, *shard_batch((fy1, fy2), dp)))
    lines.append(f"dryrun_multichip ok: fused-kernel temporal train, shard_map dp "
                 f"loss={done('fused-DP', m['loss']):.5f}")

    # stage 7: the fused conv + decode epilogue; its kernels take bf16
    # operands, and the CPU runs their plain versions in f32
    cframes, ckps = put(rng.random((n, 64, 64, 3), np.float32),
                        rng.random((n, 17, 3), np.float32) - 0.5)
    cnet = seeded(PoseNet3D("resnet18", return_heatmap=False, fuse_final_conv=True,
                            device="cpu"), 17)
    state = create_train_state(cnet, lr=1e-3,
                               apply=bf16_apply if device.type == "cuda" else None)
    m = make_dp_direct_train_step(dp)(state, *shard_batch((cframes, ckps), dp))
    lines.append(f"dryrun_multichip ok: fused conv+decode epilogue, shard_map dp "
                 f"loss={done('fused-epilogue DP', m['loss']):.5f}")
    return lines


def _entry(fn, rank: int, world: int, device: str, out_dir: str, args: tuple) -> None:
    """A spawned rank of ``run_ranks``: join the ``gloo`` world on
    ``device``, run ``fn(*args)``, save what it returns (or the
    traceback, and exit 1) to ``out_dir``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    if device == "cpu":
        torch.set_num_threads(1)
    from pose3d_tpu_torch.parallel.mesh import init_distributed

    failed = False
    try:
        init_distributed("gloo", device_type=device, init_method=f"file://{out_dir}/rdzv")
        torch.save(fn(*args), f"{out_dir}/rank{rank}.pt")
    except BaseException:
        Path(f"{out_dir}/rank{rank}.err").write_text(traceback.format_exc())
        failed = True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failed:
        sys.exit(1)


class RankError(RuntimeError):
    """A rank of ``run_ranks`` failed, exited without a result, or hung."""


def run_ranks(fn, world: int, device: str, *args, deadline: float = DEADLINE_S,
              dir=None) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one ``gloo`` world
    on ``device`` ("cpu", or "cuda": every rank on cuda:0, since ``nccl``
    takes one device a rank), which meet through a rendezvous file in a
    temporary directory (under ``dir`` where given); a CPU rank takes one
    thread. ``fn`` lives in a module the children can import. Returns each
    rank's result. As soon as one rank fails the others are ended, and so
    is every rank still running after ``deadline`` seconds (a hung
    collective); either raises RankError with the failed ranks'
    tracebacks."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=dir) as out:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, device, out, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        try:
            while any(p.is_alive() for p in procs) and time.monotonic() < end:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.05)
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        errs = [f"rank {r}:\n{e.read_text()}" for r in range(world)
                if (e := Path(out) / f"rank{r}.err").exists()]
        if errs:
            raise RankError(f"{fn.__name__} failed:\n" + "\n".join(errs))
        if hung:
            raise RankError(f"{fn.__name__}: ranks {hung} still running after {deadline} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RankError(f"{fn.__name__}: ranks exited with {bad}")
        return [torch.load(Path(out) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _dryrun_rank(n: int, device: str) -> tuple[list[str], dict[str, int]]:
    """One rank of the dry run: (the stages' lines, its kernel launches)."""
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    return _stages(n, dev), _kernel_counts()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> tuple[list[str], dict[str, int]]:
    """Run the seven stages on ``n_devices`` spawned ``gloo`` ranks on
    ``device`` ("cuda": every rank on cuda:0; "cpu") and print rank 0's
    line for each. Returns (the lines, the kernel wrappers' launches
    summed over the ranks). Raises RankError where a rank fails, or is
    still running after DEADLINE_S seconds (it is ended)."""
    results = run_ranks(_dryrun_rank, n_devices, device, n_devices, device)
    lines = results[0][0]
    for line in lines:
        print(line, flush=True)
    launches = {k: sum(r[1][k] for r in results) for k in results[0][1]}
    return lines, launches


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
