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
    fy2); the DP step's ValueError on a BatchNorm model, and
    ``make_lifter_train_step(mesh=)``'s on one whose BatchNorms are
    unbound."""
    from pose3d_tpu_torch.models.lifters import MartinezLifter
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
    from pose3d_tpu_torch.train.epoch import make_lifter_epoch_fn
    from pose3d_tpu_torch.train.steps import make_dp_lifter_train_step, make_lifter_train_step

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
    # JAX's GSPMD step takes a BatchNorm model, bound global; unbound it raises
    with pytest.raises(ValueError, match="local; bind them"):
        make_lifter_train_step(mesh=mesh)(bn, torch.zeros(2, 34), torch.zeros(2, 51))
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


# --- tensor parallelism: the DP x TP Martinez step, its checkpoint, SMPL-IK DP

TP_FIELDS = {"hidden": 256, "num_stages": 1}
TP_LR = 1e-3
TP_STEPS = 3
TP_CLIP = 0.05  # below the skewed batch's gradient norm (~0.6), so the clip binds


def tp_state(sd: dict, dtype: str, mesh=None, grad_clip: float = 0.0, dropout: float = 0.0):
    """A MartinezLifter at TP_FIELDS holding the full state dict ``sd``
    (numpy) in ``dtype``, Adam at TP_LR; with ``mesh`` its BatchNorms bound
    global and its wide layers cut over the model axis."""
    from pose3d_tpu_torch.models.lifters import MartinezLifter
    from pose3d_tpu_torch.models.norm import sync_batch_norm
    from pose3d_tpu_torch.parallel.sharding import shard_params

    model = MartinezLifter(**TP_FIELDS, dropout=dropout, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    model.to(getattr(torch, dtype))
    if mesh is not None:
        shard_params(sync_batch_norm(model, mesh), mesh)
    return create_train_state(model, lr=TP_LR, optimizer="adam", grad_clip=grad_clip)


def tp_gathered(model) -> dict:
    """The model's whole state dict (numpy): each sharded tensor gathered
    over the model axis."""
    from pose3d_tpu_torch.parallel.sharding import gathered_state_dict

    return {k: v.detach().numpy().copy() for k, v in gathered_state_dict(model).items()}


def tp_run(state, y1, y2, mesh=None, steps: int = TP_STEPS, seed: int | None = None) -> dict:
    """``steps`` steps of ``make_lifter_train_step(mesh=)`` on this rank's
    shard of (y1, y2), each followed by the plateau step; with ``seed`` the
    dropout of step i draws from ``shard_seed(seed + i, data_rank)``.
    Returns the losses, the last MPJPE sums, the local and the gathered
    state dicts, and the eval step's prediction for the whole batch."""
    from pose3d_tpu_torch.train.steps import make_lifter_eval_step, make_lifter_train_step

    step = make_lifter_train_step("mse", mesh)
    x, y = _t(y1), _t(y2)
    if mesh is not None:
        x, y = M.shard_batch((x, y), mesh)
    losses = []
    for i in range(steps):
        with torch.random.fork_rng():
            if seed is not None:
                torch.manual_seed(M.shard_seed(seed + i, 0 if mesh is None else M.data_rank(mesh)))
            m = step(state, x, y)
        state.plateau.step(m["loss"].item())
        losses.append(m["loss"].item())
    pred = make_lifter_eval_step()(state, _t(y1), _t(y2))["pred"]  # the whole batch
    return {"losses": losses, "sums": m["mpjpe_sums"].numpy(), "local": _sd(state.model),
            "full": tp_gathered(state.model), "pred": pred.numpy()}


def _opt_state(state) -> list:
    return [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
            for s in (state.optimizer.state[p] for p in state.model.parameters())]


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.detach().reshape(-1).view(torch.uint8),
                                              b.detach().reshape(-1).view(torch.uint8))


def tp_checkpoint(sd: dict, y1, y2, log_dir: str, mesh) -> dict:
    """The JAX mesh checkpoint test on ``mesh``: one step, the plateau
    step, ``save``; a fresh sharded state restores it bit for bit (every
    tensor of the model and the optimizer, the step, the plateau), then
    the resumed step equals the uninterrupted one bit for bit. Returns the
    saved state's gathered state dict and the rank's shards."""
    from pose3d_tpu_torch.train import checkpoint as ckpt

    state = tp_state(sd, "float32", mesh)
    run = tp_run(state, y1, y2, mesh, steps=1)
    ckpt.save(state, log_dir, "tp_run", batch_size=len(y1))
    restored, meta = ckpt.restore(tp_state(sd, "float32", mesh), log_dir, "tp_run")
    out = {"meta": meta, "full": run["full"], "local": run["local"],
           "step": (restored.step, state.step),
           "plateau": restored.plateau.state_dict() == state.plateau.state_dict()}
    mine, theirs = _opt_state(state), _opt_state(restored)
    out["restored_bitwise"] = (
        all(_same_bits(a, b) for a, b in zip(state.model.state_dict().values(),
                                             restored.model.state_dict().values()))
        and all(len(a) == len(b) and all(_same_bits(a[k], b[k]) for k in a)
                for a, b in zip(mine, theirs)))
    out["moment_shapes"] = [tuple(s["exp_avg"].shape) for s in theirs]
    out["param_shapes"] = [tuple(p.shape) for p in restored.model.parameters()]
    cont, res = tp_run(state, y1, y2, mesh, steps=1), tp_run(restored, y1, y2, mesh, steps=1)
    out["resumed_bitwise"] = (
        cont["losses"] == res["losses"]
        and all(cont["local"][k].tobytes() == res["local"][k].tobytes() for k in cont["local"])
        and all(_same_bits(a[k], b[k]) for a, b in zip(_opt_state(state), _opt_state(restored))
                for k in a))
    return out


def tp_restore(sd: dict, log_dir: str, mesh) -> dict:
    """A fresh sharded state of this layout restores the file of another:
    its shards, their moments' shapes, and one step after."""
    from pose3d_tpu_torch.train import checkpoint as ckpt

    state, _ = ckpt.restore(tp_state(sd, "float32", mesh), log_dir, "tp_run")
    return {"local": _sd(state.model), "step": state.step,
            "moment_shapes": [tuple(s["exp_avg"].shape) for s in _opt_state(state)],
            "param_shapes": [tuple(p.shape) for p in state.model.parameters()]}


def tp_four(sd: dict, y1, y2, log_dir: str) -> dict:
    """The 2 x 2 runs: the DP x TP step in f32 and float64, with and
    without the clip; the checkpoint; the rule on a real mesh."""
    from pose3d_tpu_torch.parallel.sharding import infer_param_sharding

    mesh = M.make_mesh(n_data=2, n_model=2)
    out = {"data_rank": M.data_rank(mesh), "model_rank": M.model_rank(mesh)}
    for dtype in ("float32", "float64"):
        for clip in (0.0, TP_CLIP):
            out[(dtype, clip)] = tp_run(tp_state(sd, dtype, mesh, clip), y1, y2, mesh)
    out["rule"] = infer_param_sharding(tp_state(sd, "float32").model, mesh)
    out["checkpoint"] = tp_checkpoint(sd, y1, y2, log_dir, mesh)
    return out


def tp_two(sd: dict, y1, y2, log_dir: str, smpl: tuple) -> dict:
    """The two-rank runs: 1 x 2 with dropout 0.5 (float64, the epoch's
    seeding), the 2 x 2 file restored into 1 x 2, and the SMPL-IK step on
    a 2 x 1 mesh (``smpl_dp``)."""
    mesh = M.make_mesh(n_data=1, n_model=2)
    state = tp_state(sd, "float64", mesh, dropout=0.5)
    return {"dropout": tp_run(state, y1, y2, mesh, seed=11),
            "restore": tp_restore(sd, log_dir, mesh),
            "smpl": smpl_dp(*smpl, M.make_mesh(n_data=2, n_model=1))}


def smpl_assembly(params: dict, dtype: str = "float64"):
    """The HybrIKPose of ``test_torch_smpl_pose.py``'s step test from the
    bridged state dict ``params`` (numpy): ResNet-18, depth 8, the 300-vertex
    synthetic body, in ``dtype``, every dropout at p = 0 (JAX's held)."""
    from pose3d_tpu_torch.models import smpl as ts
    from pose3d_tpu_torch.models.smpl_pose import HybrIKPose, PoseSMPLNet

    net = PoseSMPLNet("resnet18", depth=8, device="cpu")
    net.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)
    model = HybrIKPose(net, ts.synthetic_model(300, seed=1)).to(getattr(torch, dtype))
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


SMPL_LR = 2.0 ** -10


def smpl_dp(params: dict, arrays: tuple, mesh=None) -> dict:
    """One ``make_hybrik_train_step`` (Adam at SMPL_LR) in float64 on this
    rank's shard of ``arrays`` = (frames, cam..., uvd29, xyz17), global
    BatchNorm over ``mesh``'s data axis; without a mesh the one-process
    step on the whole batch. Returns its metrics and the net's state dict."""
    from pose3d_tpu_torch.models.norm import sync_batch_norm
    from pose3d_tpu_torch.train.smpl_steps import make_hybrik_train_step

    model = smpl_assembly(params)
    arrays = tuple(_t(a) for a in arrays)
    if mesh is not None:
        sync_batch_norm(model, mesh)
        arrays = M.shard_batch(arrays, mesh)
    frames, *cam, uvd, xyz = arrays
    state = create_train_state(model, lr=SMPL_LR, optimizer="adam")
    m = make_hybrik_train_step(mesh=mesh)(state, frames, tuple(cam), uvd, xyz, 0)
    return {"m": _metrics(m), "sd": _sd(model.net)}


SP_FIELDS = {"clip_len": 16, "hidden": 32, "n_blocks": 2, "heads": 2}
SP_SPEC = ("data", "model", None, None)
SP_LR = 1e-3
SP_STEPS = 2
SP_CLIP = 0.05  # below the batch's gradient norm, so the clip binds


def sp_state(sd: dict, dtype: str, mesh=None, flash: bool = False, grad_clip: float = 0.0):
    """A TemporalLifter at SP_FIELDS holding the state dict ``sd`` (numpy)
    in ``dtype``, AdamW at SP_LR; with ``mesh`` its frames split over the
    mesh's model axis (``sequence_parallel``)."""
    from pose3d_tpu_torch.models.temporal import TemporalLifter
    from pose3d_tpu_torch.parallel.sharding import sequence_parallel

    model = TemporalLifter(**SP_FIELDS, flash=flash,
                           activation_spec=SP_SPEC if mesh is not None else None, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    model.to(getattr(torch, dtype))
    if mesh is not None:
        sequence_parallel(model, mesh)
    return create_train_state(model, lr=SP_LR, grad_clip=grad_clip)


def sp_run(state, y1, y2, mesh=None) -> dict:
    """SP_STEPS steps of ``make_lifter_train_step(mesh=)`` on this rank's
    data shard of whole clips: the losses, the last MPJPE sums and the
    state dict (whole on every rank)."""
    from pose3d_tpu_torch.train.steps import make_lifter_train_step

    step = make_lifter_train_step("mse", mesh)
    x, y = _t(y1), _t(y2)
    if mesh is not None:
        x, y = M.shard_batch((x, y), mesh)
    losses = []
    for _ in range(SP_STEPS):
        m = step(state, x, y)
        losses.append(m["loss"].item())
    return {"losses": losses, "sums": m["mpjpe_sums"].numpy(), "full": _sd(state.model)}


def sp_ranks(sd: dict, y1, y2, n_model: int) -> dict:
    """The SP steps on a (world / n_model) x n_model mesh in f32 and
    float64, flash off and on (float64 also with the clip); the errors of
    a clip whose frames do not split and of the kernel route."""
    mesh = M.make_mesh(n_model=n_model)
    out = {"data_rank": M.data_rank(mesh), "model_rank": M.model_rank(mesh)}
    for dtype in ("float32", "float64"):
        for flash in (False, True):
            out[(dtype, flash)] = sp_run(sp_state(sd, dtype, mesh, flash), y1, y2, mesh)
    out["clip"] = sp_run(sp_state(sd, "float64", mesh, grad_clip=SP_CLIP), y1, y2, mesh)
    model = sp_state(sd, "float32", mesh).model
    for name, kw, x in (("odd", {}, _t(y1[:1, :n_model + 1])),
                        ("kernels", {"use_kernels": True}, _t(y1[:1]))):
        try:
            model(x, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out
