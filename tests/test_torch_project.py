"""The port's projectors (``pose3d_tpu_torch/models/heads.ProjectionMLP``,
``interop/weights.projection_mlp_from_flax``, the ViT projector
``JointTransformerLifter(in_dim=3, out_dim=2)``) and the projector
trainer (``cli/train_project.py``) against the JAX package's, on the CPU.

Tolerances: ``ProjectionMLP`` f32 against the flax apply with seeded
biases, BN scales and statistics: eval mode atol 1e-5; train mode (batch
statistics, the running statistics updated; the dropout held
deterministic on both sides: the port's Dropout layers in eval mode, the
flax Dropout intercepted to return its input) outputs atol 1e-5, running
mean and (unbiased) variance atol 1e-6; the ViT projector through
``vit_lifter_from_flax`` atol 1e-4 (PERF.md §2's module limit).
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import _seeded_norms, flax_apply, flax_vit, torch_vit

from pose3d_tpu_torch.cli import train_loop, train_project
from pose3d_tpu_torch.interop.weights import projection_mlp_from_flax
from pose3d_tpu_torch.models.heads import ProjectionMLP
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(2)


def _flax_projection(seed=0):
    """(flax ProjectionMLP, params, batch_stats) as numpy, biases, BN scales
    and statistics seeded."""
    import jax

    from pose3d_tpu.models.heads import ProjectionMLP as FlaxProjection

    model = FlaxProjection()
    x = np.zeros((2, 17, 3), np.float32)
    variables = jax.jit(lambda k: model.init({"params": k}, x))(jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    params = _seeded_norms(jax.tree.map(np.asarray, variables["params"]), rng, False)
    stats = _seeded_norms(jax.tree.map(np.asarray, variables["batch_stats"]), rng, True)
    return model, params, stats


def _port_projection(params, stats) -> ProjectionMLP:
    model = ProjectionMLP(device="cpu")
    model.load_state_dict(projection_mlp_from_flax(params, stats), strict=True)
    return model


def test_bridge_writes_the_reference_keys():
    """The port's state dict is the JAX package's export of the reference
    ``Projection`` (``interop/torch_weights.projection_to_torch``), key for
    key and value for value."""
    from pose3d_tpu.interop import torch_weights as tw

    _, params, stats = _flax_projection()
    sd = projection_mlp_from_flax(params, stats)
    ref = tw.projection_to_torch({"params": params, "batch_stats": stats})
    assert set(ref) <= set(sd)
    assert set(sd) - set(ref) <= {f"mlp.{i}.num_batches_tracked" for i in (2, 6, 10)}
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    assert set(sd) == set(ProjectionMLP(device="cpu").state_dict())


def test_projection_mlp_eval_matches_flax():
    model, params, stats = _flax_projection()
    x = np.random.default_rng(1).standard_normal((8, 17, 3)).astype(np.float32)
    want = flax_apply(model, params, x, stats)
    port = _port_projection(params, stats).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (8, 34) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_projection_mlp_train_batch_statistics_match_flax():
    """Train mode on one batch: outputs on the batch statistics and the
    running statistics after it, dropout held deterministic."""
    import flax.linen as nn
    import jax

    model, params, stats = _flax_projection(seed=3)
    x = np.random.default_rng(4).standard_normal((16, 17, 3)).astype(np.float32)

    def no_dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            return args[0]
        return next_fun(*args, **kwargs)

    def apply(variables, x):
        with nn.intercept_methods(no_dropout):
            return model.apply(variables, x, train=True, mutable=["batch_stats"])

    want, updates = jax.jit(apply)({"params": params, "batch_stats": stats}, x)
    port = _port_projection(params, stats).train()
    for m in port.mlp:
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    new_stats = jax.tree.map(np.asarray, updates["batch_stats"])
    for i, bn in enumerate((2, 6, 10)):
        layer, want_bn = port.mlp[bn], new_stats[f"BatchNorm_{i}"]
        np.testing.assert_allclose(layer.running_mean.numpy(), want_bn["mean"], atol=1e-6, rtol=0)
        np.testing.assert_allclose(layer.running_var.numpy(), want_bn["var"], atol=1e-6, rtol=0)
        assert not np.allclose(layer.running_mean.numpy(), stats[f"BatchNorm_{i}"]["mean"])


def test_vit_bridge_carries_the_projector_configuration():
    """``vit_lifter_from_flax`` on the flax ``JointTransformerLifter(in_dim=3,
    out_dim=2)`` at the default widths: the port's projector loads it
    strictly and maps (B, 17, 3) to (B, 17, 2) as flax does."""
    model, params = flax_vit(seed=5, in_dim=3, out_dim=2)
    x = np.random.default_rng(6).standard_normal((4, 17, 3)).astype(np.float32)
    want = flax_apply(model, params, x)
    port = torch_vit(params, in_dim=3, out_dim=2)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 17, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_init_weights_is_seeded():
    a = ProjectionMLP(device="cpu").init_weights(torch.Generator().manual_seed(0))
    b = ProjectionMLP(device="cpu").init_weights(torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert a.mlp[2].running_var.min() >= 0.5


# --- the trainer -------------------------------------------------------------

def test_cli_trains_a_projector_that_the_loop_freezes(tmp_path, capsys):
    log_dir = tmp_path / "logs"
    argv = ["--cpu", "--n_epochs", "2", "--data.synthetic_frames", "256", "--log_dir",
            str(log_dir)]
    state = train_project.main(argv)
    assert ckpt.exists(log_dir, "project_run")  # the default run name
    assert ckpt.load_meta(log_dir, "project_run") == {"batch_size": 64}
    records = [r for r in map(json.loads, (log_dir / "runs" / "project_run.jsonl").read_text()
                              .splitlines()) if "epoch" in r]
    assert len(records) == 2 and records[1]["train_loss"] < records[0]["train_loss"]
    for r in records:
        assert all(np.isfinite(r[k]) for k in ("train_mpjpe", "val_mpjpe"))
    assert records[0]["lr"] == 1e-4
    x = torch.zeros(3, 17, 3)
    with torch.no_grad():
        assert state.model(x).shape == (3, 17, 2)

    projector = train_loop._load_frozen(
        JointTransformerLifter(in_dim=3, out_dim=2, device="cpu"), log_dir, "project_run")
    assert "frozen model restored from project_run" in capsys.readouterr().out
    for k, v in state.model.state_dict().items():
        assert torch.equal(projector.state_dict()[k], v), k
    assert not projector.training and not any(p.requires_grad for p in projector.parameters())


def test_cli_keeps_a_given_run_name_and_needs_cuda_or_cpu(tmp_path, monkeypatch):
    train_project.main(["--cpu", "--n_epochs", "1", "--data.synthetic_frames", "128",
                        "--batch_size", "16", "--run_name", "proj", "--log_dir", str(tmp_path)])
    assert ckpt.exists(tmp_path, "proj")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_project.main(["--log_dir", str(tmp_path)])
