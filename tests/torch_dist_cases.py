"""Rank bodies of the port's data-parallel tests (``tests/test_torch_
parallel*.py``), run by ``torch_dist_util.spawn`` in processes that
import torch and the port only. Each takes numpy inputs from the parent,
joins the mesh of the spawned world and returns numpy results; the
parent compares them with the one-process steps and with JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pose3d_tpu_torch.parallel import mesh as M
from pose3d_tpu_torch.train.state import create_train_state


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sd(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def mesh_checks(batch: np.ndarray) -> dict:
    """make_mesh over the world (and 2 x 2 on four ranks), its error, the
    rank's shard of ``batch``, the reductions and the replication check;
    then, with the process group gone, a DP step that must raise."""
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {"rank": rank}
    mesh = M.make_mesh()
    out["names"], out["shape"] = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    if world == 4:
        mesh = M.make_mesh(n_data=2, n_model=2)
        out["shape_2x2"] = tuple(mesh.shape)
        out["data_rank_2x2"] = M.data_rank(mesh)
    with pytest.raises(ValueError) as err:
        M.make_mesh(n_data=3, n_model=1)
    out["error"] = str(err.value)
    out["shard"] = M.shard_batch(batch, mesh)
    out["shard_pair"] = M.shard_batch((batch, _t(batch)), mesh)[1].numpy()
    with pytest.raises(ValueError):
        M.shard_batch(batch[:-1], mesh)
    x = torch.tensor([float(rank + 1), 2.0 ** -30 * (rank + 1)], dtype=torch.float64)
    y = torch.full((3,), float(rank), dtype=torch.float32)
    M.psum_([x, y], mesh)
    out["psum"] = (x.numpy(), y.numpy())
    z = torch.tensor([float(rank)])
    M.pmean_([z], mesh)
    out["pmean"] = z.numpy()
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    M.broadcast_parameters(lin, mesh)
    out["broadcast"] = lin.weight.detach().numpy()
    same = [torch.ones(2, dtype=torch.bfloat16), torch.arange(3.0)]
    M.check_replicated(same)
    same[1][0] += rank  # rank 0 unchanged, every other rank differs
    try:
        M.check_replicated(same)
        out["replication_error"] = None
    except RuntimeError as e:
        out["replication_error"] = str(e)
    out["bn"] = bn_binding_checks(mesh)
    dist.barrier()
    dist.destroy_process_group()
    from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step

    state = create_train_state(torch.nn.Linear(2, 3), lr=1e-3, optimizer="sgd")
    with pytest.raises(RuntimeError, match="no process group"):
        make_dp_lifter_train_step(mesh)(state, torch.zeros(2, 2), torch.zeros(2, 3))
    return out


def bn_binding_checks(mesh) -> dict:
    """The BatchNorm contract is the model's: the steps check it and never
    change it. The ValueError of each step given the other contract, the
    data group's size on a bound BatchNorm, and the module local again
    after unbinding."""
    from pose3d_tpu_torch.models.norm import F32BatchNorm1d, sync_batch_norm
    from pose3d_tpu_torch.train.image_steps import (make_direct_train_step,
                                                    make_dp_direct_train_step)
    from pose3d_tpu_torch.train.loop_steps import LoopState, make_loop_train_step

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    net = torch.nn.Sequential(torch.nn.Linear(2, 3), F32BatchNorm1d(3, device="cpu"))
    state = create_train_state(net, lr=1e-3, optimizer="sgd")
    frames, kp3d = torch.zeros(2, 4, 4, 3), torch.zeros(2, 17, 3)
    out = {"global_step_local_model": error(
               lambda: make_direct_train_step(mesh=mesh)(state, frames, kp3d)),
           "loop_step_local_models": error(
               lambda: make_loop_train_step(mesh=mesh)(LoopState(state, state), frames,
                                                       kp3d[..., :2], kp3d))}
    sync_batch_norm(net, mesh)
    out["bound_group_size"] = dist.get_world_size(net[1].process_group)
    out["local_step_global_model"] = error(
        lambda: make_dp_direct_train_step(mesh)(state, frames, kp3d))
    sync_batch_norm(net, None)
    out["unbound"] = net[1].process_group is None and net.batch_norm_group is None
    out["bf16"] = global_bn_bf16(mesh)
    return out


def bf16_bn_inputs():
    """A bf16 (8, 6, 5, 4) channels_last batch, offset and scaled a channel
    and skewed across its halves, a seeded F32BatchNorm2d and an upstream
    gradient, all made alike in every process."""
    from pose3d_tpu_torch.models.norm import F32BatchNorm2d, seed_batch_norm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, 5, 4, generator=gen) * torch.linspace(0.5, 3.0, 6).view(1, 6, 1, 1)
    x = x + torch.linspace(-2.0, 4.0, 6).view(1, 6, 1, 1)
    x[:4] += 1.5
    bn = F32BatchNorm2d(6, device="cpu")
    seed_batch_norm(bn, gen)
    g = torch.randn(x.shape, generator=gen)
    return (x.bfloat16().contiguous(memory_format=torch.channels_last), bn,
            g.bfloat16().contiguous(memory_format=torch.channels_last))


def global_bn_bf16(mesh) -> dict:
    """The global BatchNorm on this rank's rows of ``bf16_bn_inputs``: its
    bf16 output and input gradient (of sum(y·g)), the weight and bias
    gradients summed over the data axis, and the running statistics."""
    from pose3d_tpu_torch.models.norm import sync_batch_norm

    x, bn, g = bf16_bn_inputs()
    x, g = M.shard_batch((x, g), mesh)
    x = x.detach().requires_grad_(True)
    sync_batch_norm(bn, mesh).train()
    y = bn(x)
    (y.float() * g.float()).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    M.psum_(grads, mesh)
    return {"y": y.detach().float().numpy(), "dx": x.grad.float().numpy(),
            "channels_last": y.is_contiguous(memory_format=torch.channels_last),
            "dtypes": (str(y.dtype), str(x.grad.dtype)),
            "dw": grads[0].numpy(), "db": grads[1].numpy(),
            "running": (bn.running_mean.numpy(), bn.running_var.numpy())}


def dp_lifter(fields: dict, sd: dict, y1, y2, y1e, y2e, fused_sd, fy1, fy2) -> dict:
    """The DP lifter step on this rank's shard of (y1, y2) and the DP epoch
    on its shards of the stacks (y1e, y2e), each from ``sd`` (a
    TemporalLifter at ``fields``, SGD lr 1e-3); the DP step on the fused
    training apply (its plain versions here) from ``fused_sd`` on (fy1,
    fy2); and the ValueError on a BatchNorm model."""
    from pose3d_tpu_torch.models.lifters import MartinezLifter
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
    from pose3d_tpu_torch.train.epoch import make_lifter_epoch_fn
    from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step

    mesh = M.make_mesh()

    def state(fields, sd, apply=None):
        model = TemporalLifter(**fields, device="cpu")
        model.load_state_dict({k: _t(v) for k, v in sd.items()})
        return create_train_state(model, lr=1e-3, optimizer="sgd", apply=apply)

    out = {}
    s = state(fields, sd)
    m = make_dp_lifter_train_step(mesh)(s, *M.shard_batch((_t(y1), _t(y2)), mesh))
    out["step"] = {"loss": m["loss"].item(), "sums": m["mpjpe_sums"].numpy(),
                   "params": _sd(s.model)}
    s = state(fields, sd)
    e1, e2 = (_t(a) for a in M.shard_batch((y1e.swapaxes(0, 1), y2e.swapaxes(0, 1)), mesh))
    m = make_lifter_epoch_fn(mesh=mesh)(s, e1.swapaxes(0, 1), e2.swapaxes(0, 1), 5)
    out["epoch"] = {"loss": m["loss"].item(), "last": m["last_batch_loss"].item(),
                    "sums": m["mpjpe_sums"].numpy(), "params": _sd(s.model)}
    s = state({"clip_len": fy1.shape[1], "n_blocks": 1}, fused_sd,
              apply=temporal_train_forward_fused)
    m = make_dp_lifter_train_step(mesh)(s, *M.shard_batch((_t(fy1), _t(fy2)), mesh))
    out["fused"] = {"loss": m["loss"].item(), "sums": m["mpjpe_sums"].numpy(),
                    "params": _sd(s.model)}
    bn = create_train_state(MartinezLifter(hidden=16, num_stages=1, device="cpu"), lr=1e-3)
    with pytest.raises(ValueError, match="stats-free"):
        make_dp_lifter_train_step(mesh)(bn, torch.zeros(2, 34), torch.zeros(2, 51))
    return out


# --- the image models: local and global BatchNorm ----------------------------

IMAGE_LR = 2.0 ** -10
IMAGE_WD = 1e-8
ROUTES = {"nhwc": {"return_heatmap": False},
          "fused": {"return_heatmap": False, "fuse_final_conv": True}}
LOOP_VIT = {"hidden": 32, "heads": 4, "n_blocks": 1}
LOOP_DEPTH = 8


def _metrics(m) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in m.items()}


def image_step(job: tuple, mesh=None) -> dict:
    """One step of ``job`` = (kind, route, weights, dtype name, arrays):

    - "dp_direct": ``make_dp_direct_train_step`` (local BatchNorm; with no
      mesh the one-process ``make_direct_train_step``);
    - "direct": ``make_direct_train_step(mesh=)`` (global BatchNorm);
    - "posenet2d": a PoseNet2D step, MSE on the coordinates, global
      BatchNorm, gradients averaged (the JAX mesh suite's step);
    - "loop": ``make_loop_train_step(mesh=)``, ``sep`` + flip + projector.

    ``arrays`` are the global batch; under a mesh this rank takes its
    shard. Returns the metrics and the trained models' state dicts."""
    from torch_port_util import torch_posenet, torch_posenet2d, torch_vit

    from pose3d_tpu_torch import losses
    from pose3d_tpu_torch.models.norm import sync_batch_norm
    from pose3d_tpu_torch.train.image_steps import (make_direct_train_step,
                                                    make_dp_direct_train_step)
    from pose3d_tpu_torch.train.loop_steps import LoopState, freeze, make_loop_train_step
    from pose3d_tpu_torch.train.steps import apply_gradients

    kind, route, weights, dtype, arrays = job
    dtype = getattr(torch, dtype)
    arrays = tuple(_t(a) for a in arrays)
    if mesh is not None:
        arrays = M.shard_batch(arrays, mesh)
    if kind in ("dp_direct", "direct"):
        model = torch_posenet(*weights, architecture="resnet18", **ROUTES[route]).to(dtype)
        state = create_train_state(model, lr=IMAGE_LR, optimizer="adam", weight_decay=IMAGE_WD)
        if kind == "dp_direct" and mesh is not None:
            step = make_dp_direct_train_step(mesh)
        else:
            if mesh is not None:
                sync_batch_norm(model, mesh)
            step = make_direct_train_step(mesh=mesh)
        return {"m": _metrics(step(state, *arrays)), "sd": _sd(model)}
    if kind == "posenet2d":
        model = torch_posenet2d(*weights, architecture="resnet18").to(dtype)
        state = create_train_state(model, lr=IMAGE_LR)
        if mesh is not None:
            sync_batch_norm(model, mesh)
        frames, kp2d = arrays
        model.train()
        loss = losses.mse(model(frames).reshape(kp2d.shape), kp2d)
        apply_gradients(loss, state, mesh=mesh)
        loss = loss.detach().clone()
        if mesh is not None:
            M.pmean_([loss], mesh)
        return {"m": {"loss": loss.numpy()}, "sd": _sd(model)}
    (p2, s2), (p3, s3), lifter, projector = weights
    state = LoopState(
        net2d=create_train_state(torch_posenet2d(p2, s2, architecture="resnet18").to(dtype),
                                 lr=IMAGE_LR),
        net3d=create_train_state(torch_posenet(p3, s3, architecture="resnet18",
                                               depth=LOOP_DEPTH).to(dtype), lr=IMAGE_LR),
        lifter=freeze(torch_vit(lifter, **LOOP_VIT).to(dtype)),
        projector=freeze(torch_vit(projector, in_dim=3, out_dim=2, **LOOP_VIT).to(dtype)))
    if mesh is not None:
        sync_batch_norm(state.net2d.model, mesh)
        sync_batch_norm(state.net3d.model, mesh)
    step = make_loop_train_step(triangle=True, flip=True, project=True, triangle_mode="sep",
                                mesh=mesh)
    m = step(state, *arrays)
    return {"m": _metrics(m), "sd2d": _sd(state.net2d.model), "sd3d": _sd(state.net3d.model)}


def image_steps(jobs: list) -> list:
    """``image_step`` of each job on this rank's shard."""
    mesh = M.make_mesh()
    return [image_step(job, mesh) for job in jobs]


# --- serving and the trainer CLI ---------------------------------------------

SERVE_MODELS = {  # name: (family, fields, dtype, max_batch, min_bucket)
    "vit_bf16": ("vit", {}, "bfloat16", 32, 8),
    "vit_f32": ("vit", {"hidden": 64, "n_blocks": 1, "heads": 2}, "float32", 128, 32),
    "martinez_bf16": ("martinez", {}, "bfloat16", 64, 16),
    "martinez_f32": ("martinez", {"hidden": 128, "num_stages": 1}, "float32", 64, 16),
}


def serve_model(name: str):
    """The seeded lifter of ``SERVE_MODELS[name]`` (BatchNorm statistics
    seeded too), in eval mode on the CPU."""
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter, MartinezLifter
    from pose3d_tpu_torch.models.norm import seed_batch_norm

    family, fields, dtype, _, _ = SERVE_MODELS[name]
    cls = JointTransformerLifter if family == "vit" else MartinezLifter
    gen = torch.Generator().manual_seed(len(name))
    model = cls(**fields, device="cpu").init_weights(gen)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            seed_batch_norm(m, gen)
    return model.to(getattr(torch, dtype)).eval()


def service(name: str, mesh=None):
    from pose3d_tpu_torch.serving import LifterService

    _, _, _, max_batch, min_bucket = SERVE_MODELS[name]
    return LifterService(serve_model(name), device="cpu", max_batch=max_batch,
                         min_bucket=min_bucket, mesh=mesh)


def dp_serving(requests: dict) -> dict:
    """Each service of ``SERVE_MODELS`` over the world's mesh: its buckets,
    whether a fused route serves it, and its answers to ``requests[name]``
    (a list of (N, 17, 2) arrays)."""
    mesh = M.make_mesh()
    out = {}
    for name, reqs in requests.items():
        svc = service(name, mesh)
        out[name] = {"buckets": svc.buckets, "fused": svc.fused,
                     "out": [svc.lift(kp) for kp in reqs]}
    return out


def cli_main(module: str, argv: list, workdir: str) -> dict:
    """``pose3d_tpu_torch.cli.<module>.main(argv)`` under the spawned
    launcher, from a working directory of this rank's own (a relative
    ``--log_dir`` lands there, so what each rank writes stays apart): the
    trained models' state dicts and the files this rank wrote."""
    import importlib
    import os
    from pathlib import Path

    cli = importlib.import_module(f"pose3d_tpu_torch.cli.{module}")
    cwd = Path(workdir) / f"rank{dist.get_rank()}"
    cwd.mkdir(parents=True)
    os.chdir(cwd)
    state = cli.main(argv)
    assert not dist.is_initialized()  # main left the group
    nets = {"2d": state.net2d, "3d": state.net3d} if hasattr(state, "net2d") else {"": state}
    bound = [f"{tag}.{name}" for tag, net in nets.items() for name, m in net.model.named_modules()
             if getattr(m, "process_group", None) is not None
             or getattr(m, "batch_norm_group", None) is not None]
    sd = {f"{tag}.{k}": v for tag, net in nets.items() for k, v in _sd(net.model).items()}
    return {"sd": sd,
            "files": sorted(str(p.relative_to(cwd)) for p in cwd.rglob("*") if p.is_file()),
            "bound": bound}
