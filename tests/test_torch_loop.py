"""The port's consistency loop (``pose3d_tpu_torch/train/loop_steps.py``,
``cli/train_loop.py``) and triangle losses (``losses.py``) against the
JAX package's, on the CPU.

Models: ``PoseNet2D`` (ResNet-18, the flax weights of
``torch_port_util.flax_posenet2d``) and ``PoseNet3D`` (ResNet-18, volume
depth 8, the heatmap route the loop trainer builds), 64 x 64 float
frames, B = 2; a frozen ViT lifter and a frozen ViT projector (hidden 32,
1 block, 4 heads, seeded biases and LayerNorms); AdamW (weight decay
1e-2) at lr 2^-10, exact in f32 and f64.

Tolerances:

- the triangle losses, f32 inputs, every term and the total: atol 1e-6
  (the same expressions);
- one loop train step in float64 on both sides (x64 on) in three
  configurations (plain MSE; ``sep`` with flip and projector; ``cycle``
  with projector): the loss, every term and the MPJPE sums rtol 1e-10;
  every parameter of both image models after AdamW atol 1e-8 (Adam's
  first step is -lr·g/(|g| + eps): a gradient near eps moves by up to
  lr·δg/eps); the BatchNorm running mean and (unbiased) variance atol
  1e-10; the frozen models unchanged, bitwise;
- the eval step in float64, flip on and off: loss, 2D loss and MPJPE sums
  rtol 1e-10;
- the plateau schedules over a scripted metric sequence: each lr within
  rtol 1e-6 of JAX's (its lr is f32);
- uint8 frames: the port's steps give, bitwise, their result on the float
  frames / 256; JAX's loop steps do not normalise (its eval on uint8
  frames equals its eval on the same values as floats, rtol 1e-12).
"""

import functools
import json

import numpy as np
import pytest
import torch

from torch_port_util import (_seeded_norms, flax_posenet, flax_posenet2d, flax_vit,
                             torch_posenet, torch_posenet2d, torch_vit)

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.cli import train_loop as cli
from pose3d_tpu_torch.config import LoopConfig, parse_config
from pose3d_tpu_torch.interop.weights import posenet3d_from_flax
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.loop_steps import (LoopState, freeze, loop_plateau_step,
                                               make_loop_eval_step, make_loop_train_step)
from pose3d_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

LR = 2.0 ** -10
B = 2
SIZE = 64
DEPTH = 8
VIT = {"hidden": 32, "heads": 4, "n_blocks": 1}
CONFIGS = {
    "mse": {"triangle": False, "flip": False, "project": False},
    "sep_flip_project": {"triangle": True, "flip": True, "project": True,
                         "triangle_mode": "sep"},
    "cycle_project": {"triangle": True, "flip": False, "project": True,
                      "triangle_mode": "cycle"},
}


# --- the triangle losses ---------------------------------------------------

@pytest.mark.parametrize("mode", ["cycle", "sep"])
@pytest.mark.parametrize("proj", [False, True])
def test_triangle_losses_match_jax(mode, proj):
    from pose3d_tpu import losses as jl

    rng = np.random.default_rng(1)
    p2, g2 = rng.random((2, 4, 17, 2), dtype=np.float32)
    p3, g3, lp, lg = (0.3 * rng.standard_normal((4, 4, 17, 3))).astype(np.float32)
    pp, pg = rng.random((2, 4, 17, 2), dtype=np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    if mode == "cycle":
        want = jl.triangle_loss(p2, p3, lp, g2, g3, pp if proj else None)
        got = losses.triangle_loss(t(p2), t(p3), t(lp), t(g2), t(g3), t(pp) if proj else None)
    else:
        want = jl.triangle_loss_sep(p2, p3, lg, lp, g2, g3, pp if proj else None,
                                    pg if proj else None)
        got = losses.triangle_loss_sep(t(p2), t(p3), t(lg), t(lp), t(g2), t(g3),
                                       t(pp) if proj else None, t(pg) if proj else None)
    assert set(got[1]) == set(want[1])
    assert ("loss_proj" in got[1]) == proj
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(v), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_root_centring_is_per_pose():
    """The projection terms centre each pose on its own root joint, not on
    the batch's first sample (the reference's indexing bug)."""
    rng = np.random.default_rng(2)
    p2 = torch.from_numpy(rng.random((3, 17, 2)))
    shift = torch.tensor([[[5.0, -3.0]], [[0.0, 0.0]], [[-2.0, 7.0]]], dtype=torch.float64)
    proj = p2 + shift  # each pose moved as a whole
    g3 = torch.zeros(3, 17, 3, dtype=torch.float64)
    _, terms = losses.triangle_loss(p2, g3, g3, p2, g3, proj)
    assert terms["loss_proj"].item() < 1e-15


# --- the loop step in float64 against the JAX step --------------------------

@functools.cache
def _weights():
    """((2D params, stats), (3D params, stats), lifter params, projector
    params) as f32 numpy."""
    p2 = flax_posenet2d("resnet18")
    p3 = flax_posenet("resnet18", depth=DEPTH)
    _, lifter = flax_vit(seed=1, **VIT)
    _, projector = flax_vit(seed=2, in_dim=3, out_dim=2, **VIT)
    return (p2, p3, _seeded_norms(lifter, np.random.default_rng(101), False),
            _seeded_norms(projector, np.random.default_rng(102), False))


def _jax_loop_state():
    """(JAX LoopState in float64, the lifter's and projector's flax modules);
    call inside ``jax.enable_x64(True)``."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D
    from pose3d_tpu.models.lifters import JointTransformerLifter
    from pose3d_tpu.train.loop_steps import LoopState as JaxLoopState
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    def train_state(model, params, stats):
        tx = make_optimizer(LR, "adamw")
        params = f64(params)
        return TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=f64(stats),
                          opt_state=tx.init(params), plateau=plateau_init(LR), tx=tx,
                          apply_fn=model.apply)

    (p2, s2), (p3, s3), lifter, projector = _weights()
    state = JaxLoopState(
        net2d=train_state(PoseNet2D(architecture="resnet18", dtype=jnp.float64), p2, s2),
        net3d=train_state(PoseNet3D(architecture="resnet18", depth=DEPTH, dtype=jnp.float64),
                          p3, s3),
        lifter_params=f64(lifter), projector_params=f64(projector))
    return (state, JointTransformerLifter(**VIT, dtype=jnp.float64),
            JointTransformerLifter(in_dim=3, out_dim=2, **VIT, dtype=jnp.float64))


def _port_state(dtype=torch.float64) -> LoopState:
    (p2, s2), (p3, s3), lifter, projector = _weights()
    model2d = torch_posenet2d(p2, s2, architecture="resnet18").to(dtype)
    model3d = torch_posenet(p3, s3, architecture="resnet18", depth=DEPTH).to(dtype)
    return LoopState(net2d=create_train_state(model2d, lr=LR),
                     net3d=create_train_state(model3d, lr=LR),
                     lifter=freeze(torch_vit(lifter, **VIT).to(dtype)),
                     projector=freeze(torch_vit(projector, in_dim=3, out_dim=2, **VIT).to(dtype)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, SIZE, SIZE, 3)), rng.random((B, 17, 2)),
            0.3 * rng.standard_normal((B, 17, 3)))


def _jax_sd(net) -> dict:
    """A JAX TrainState's params and batch stats as the port's state dict
    (``PoseNet2D`` has ``PoseNet3D``'s keys), float64 numpy."""
    import jax

    sd = posenet3d_from_flax(jax.tree.map(np.asarray, net.params),
                             jax.tree.map(np.asarray, net.batch_stats))
    return {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


def _assert_model_close(model, want: dict):
    got = model.state_dict()
    for name, w in want.items():
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got[name].numpy(), w, atol=atol, rtol=0, err_msg=name)


@functools.cache
def _jax_train_step(config: str, seed: int):
    """The JAX loop step on ``_batch(seed)`` in float64: (metrics, 2D state
    dict, 3D state dict) after it."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.loop_steps import make_loop_train_step as jax_step

    frames, y1, y2 = _batch(seed)
    with jax.enable_x64(True):
        state, lifter, projector = _jax_loop_state()
        step = jax_step(lifter.apply, projector.apply, donate=False, **CONFIGS[config])
        state, m = step(state, jnp.asarray(frames), jnp.asarray(y1), jnp.asarray(y2),
                        jax.random.key(0))
        return jax.tree.map(np.asarray, m), _jax_sd(state.net2d), _jax_sd(state.net3d)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_f64_loop_step_matches_the_jax_step(config):
    """Loss, every term, the MPJPE sums; both models' parameters and
    running statistics after the step; the frozen models untouched."""
    frames, y1, y2 = _batch(3)
    jm, want2d, want3d = _jax_train_step(config, 3)
    state = _port_state()
    frozen = {k: v.clone() for k, v in state.lifter.state_dict().items()}
    m = make_loop_train_step(**CONFIGS[config])(
        state, torch.from_numpy(frames), torch.from_numpy(y1), torch.from_numpy(y2))
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(m[k].numpy(), v, rtol=1e-10, err_msg=k)
    assert state.net2d.step == state.net3d.step == 1
    _assert_model_close(state.net2d.model, want2d)
    _assert_model_close(state.net3d.model, want3d)
    for k, v in state.lifter.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    for p in (*state.lifter.parameters(), *state.projector.parameters()):
        assert not p.requires_grad and p.grad is None


def test_lift_term_differentiates_through_the_frozen_lifter():
    """In ``cycle`` mode without the projector, L1(lift(pred2d), pred3d)
    moves the 2D model: its gradient differs from the step without the
    lifter's term, though the lifter itself takes none."""
    frames, y1, y2 = (torch.from_numpy(a) for a in _batch(4))
    grads = []
    for lifter_scale in (1.0, 0.0):
        state = _port_state()
        with torch.no_grad():
            state.lifter.mlp[2].weight.mul_(lifter_scale)  # 0: the lift is a constant
            state.lifter.mlp[2].bias.mul_(lifter_scale)
        make_loop_train_step(triangle=True, triangle_mode="cycle")(state, frames, y1, y2)
        grads.append(state.net2d.model.final_layer.weight.grad.clone())
    assert not torch.allclose(grads[0], grads[1])


def test_loop_step_rejects_a_triangle_without_lifter():
    with pytest.raises(ValueError, match="sep|cycle"):
        make_loop_train_step(triangle=True, triangle_mode="both")
    state = _port_state()
    state.lifter = None
    frames, y1, y2 = (torch.from_numpy(a) for a in _batch(3))
    with pytest.raises(ValueError, match="lifter"):
        make_loop_train_step(triangle=True)(state, frames, y1, y2)


@functools.cache
def _jax_eval(flip: bool) -> dict:
    """The JAX eval step on ``_batch(5)``'s frames in float64 ("float"), and
    without flip also on them as uint8 (x 256) and on those uint8 values as
    floats: {kind: metrics}."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.loop_steps import make_loop_eval_step as jax_eval

    frames, y1, y2 = _batch(5)
    u8 = (frames * 256).astype(np.uint8)
    kinds = {"float": frames}
    if not flip:
        kinds |= {"uint8": u8, "uint8_values": u8.astype(np.float64)}
    with jax.enable_x64(True):
        state, _, _ = _jax_loop_state()
        step = jax_eval(flip)
        return {k: jax.tree.map(np.asarray, step(state, jnp.asarray(f), jnp.asarray(y1),
                                                 jnp.asarray(y2)))
                for k, f in kinds.items()}


@pytest.mark.parametrize("flip", [False, True])
def test_eval_step_matches_jax(flip):
    frames, y1, y2 = (torch.from_numpy(a) for a in _batch(5))
    want = _jax_eval(flip)["float"]
    state = _port_state()
    got = make_loop_eval_step(flip)(state, frames, y1, y2)
    assert set(got) == set(want) == {"loss", "loss_2d", "mpjpe_sums"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-10, err_msg=k)
    assert not state.net2d.model.training and not state.net3d.model.training


def test_uint8_frames_are_divided_by_256():
    """The port normalises uint8 frames (the direct trainer's convention);
    the JAX loop steps do not, and feed 0-255 pixels to the models."""
    frames, y1, y2 = _batch(5)
    u8 = (frames * 256).astype(np.uint8)
    t = torch.from_numpy
    out = []
    for f in (t(u8), t(u8).double() / 256.0):
        state = _port_state()
        m = make_loop_train_step(triangle=True, flip=True, project=True)(state, f, t(y1), t(y2))
        e = make_loop_eval_step(flip=True)(state, f, t(y1), t(y2))
        out.append((m, e, state.net3d.model.state_dict()))
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
    for k, v in out[0][2].items():
        assert torch.equal(v, out[1][2][k]), k
    # the JAX fault, pinned: its eval on uint8 frames is its eval on the
    # unnormalised values, and not the port's
    jax_u8, jax_raw = _jax_eval(False)["uint8"], _jax_eval(False)["uint8_values"]
    np.testing.assert_allclose(jax_u8["loss"], jax_raw["loss"], rtol=1e-12)
    port = make_loop_eval_step(False)(_port_state(), t(u8), t(y1), t(y2))
    assert abs(port["loss"].item() - float(jax_u8["loss"])) > 1e-6


def test_plateau_step_matches_jax():
    """Both schedules, from different lrs, over one scripted metric
    sequence: reductions after 3 bad epochs, a cooldown of 2, the floor."""
    import jax.numpy as jnp

    from pose3d_tpu.train.loop_steps import LoopState as JaxLoopState
    from pose3d_tpu.train.loop_steps import loop_plateau_step as jax_plateau
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState

    def jax_state(lr):
        return TrainState(step=jnp.asarray(0), params={}, batch_stats={}, opt_state=(),
                          plateau=plateau_init(lr), tx=None, apply_fn=None)

    def port_state(lr):
        return create_train_state(torch.nn.Linear(2, 2), lr=lr)

    lrs = (5e-4, 1e-5)
    js = JaxLoopState(net2d=jax_state(lrs[0]), net3d=jax_state(lrs[1]))
    ps = LoopState(net2d=port_state(lrs[0]), net3d=port_state(lrs[1]))
    metrics = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6,
               0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    seen = set()
    for metric in metrics:
        js = jax_plateau(js, jnp.float32(metric))
        loop_plateau_step(ps, torch.tensor(metric))
        for jnet, pnet in ((js.net2d, ps.net2d), (js.net3d, ps.net3d)):
            np.testing.assert_allclose(pnet.lr, float(jnet.plateau.lr), rtol=1e-6)
        seen.add((round(ps.net2d.lr, 12), round(ps.net3d.lr, 12)))
    assert ps.net2d.lr < lrs[0] and ps.net3d.lr == 5e-6 and len(seen) > 3


# --- the CLI ----------------------------------------------------------------

def _tiny_argv(log_dir, *extra):
    return ["--cpu", "--architecture", "resnet18", "--image_size", "64", "--batch_size", "4",
            "--n_epochs", "2", "--data.synthetic_frames", "16", "--log_dir", str(log_dir),
            *extra]


def test_config_defaults_and_flags():
    cfg = LoopConfig()
    assert (cfg.architecture, cfg.batch_size, cfg.image_size, cfg.lr, cfg.bf16) == \
        ("resnet50", 64, 256, 5e-4, True)
    assert (cfg.data.action, cfg.data.split_rate) == ("Walking", 64)
    cfg = parse_config(LoopConfig, ["--cpu", "--triangle", "1", "--triangle_mode", "cycle",
                                    "--lifter_checkpoint", "lift", "--resume", "true"])
    assert (cfg.device, cfg.triangle, cfg.triangle_mode, cfg.lifter_checkpoint, cfg.resume) \
        == ("cpu", True, "cycle", "lift", True)


def test_cli_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_tiny_argv(tmp_path)[1:])


def test_cli_trains_with_frozen_checkpoints(tmp_path, capsys):
    """Both frozen models restored from port checkpoints, ``<run>_2d`` /
    ``_3d`` written, the per-term averages in each epoch's record."""
    from pose3d_tpu_torch.cli.train_lift import build_lifter

    logs = tmp_path / "logs"
    for name, model in (("lift", build_lifter("vit")),
                        ("proj", JointTransformerLifter(in_dim=3, out_dim=2, device="cpu"))):
        model.init_weights(torch.Generator().manual_seed(7))
        ckpt.save(create_train_state(model, lr=1e-3), logs, name)
    state = cli.main(_tiny_argv(logs, "--triangle", "1", "--flip", "1", "--project", "1",
                                "--lifter_checkpoint", "lift", "--projector_checkpoint", "proj",
                                "--run_name", "loop"))
    out = capsys.readouterr().out
    assert out.count("frozen model restored from") == 2
    lifter = ckpt.restore_params(logs, "lift", build_lifter("vit"))
    for k, v in lifter.state_dict().items():
        assert torch.equal(state.lifter.state_dict()[k], v), k
    assert state.net2d.step == state.net3d.step == 2 * (16 // 4)
    for tag, cls in (("2d", "PoseNet2D"), ("3d", "PoseNet3D")):
        assert ckpt.exists(logs, f"loop_{tag}")
        sd = ckpt.peek_params(logs, f"loop_{tag}")
        want = getattr(state, f"net{tag}").model.state_dict()
        assert set(sd) == set(want), cls
    records = [json.loads(line) for line in (logs / "runs" / "loop.jsonl").read_text()
               .splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert len(epochs) == 2
    for r in epochs:
        for k in ("train_loss", "train_mpjpe", "val_loss", "val_mpjpe", "loss_2d", "loss_3d",
                  "loss_domain_gap", "loss_lift", "loss_gap_proj", "loss_proj"):
            assert np.isfinite(r[k]), k
    assert records[0]["event"] == "config" and records[-1]["event"] == "finish"


def test_cli_fresh_init_without_checkpoints(tmp_path, capsys):
    state = cli.main(_tiny_argv(tmp_path, "--n_epochs", "1", "--triangle", "1",
                                "--triangle_mode", "cycle", "--project", "1",
                                "--lifter_checkpoint", "missing"))
    out = capsys.readouterr().out
    assert "frozen checkpoint 'missing' not found; fresh init" in out
    assert "frozen checkpoint None not found; fresh init" in out
    assert state.lifter is not None and state.projector is not None
    record = [r for r in map(json.loads, (tmp_path / "runs" / "loop_run.jsonl").read_text()
                             .splitlines()) if "epoch" in r][0]
    assert {"loss_2d", "loss_3d", "loss_lift", "loss_proj"} <= set(record)
    assert "loss_domain_gap" not in record

