"""The port's phase-1 training stack against the JAX package's, on the
CPU: the lifter train and eval steps (``pose3d_tpu_torch/train/
steps.py``, flip test-time augmentation included), the whole-epoch
functions (``train/epoch.py``), the trainer CLI (``cli/train_lift.py``,
its end-of-run renders byte for byte JAX's), the metric logger's wandb
mirror (``train/logging.py``, a fake ``wandb`` module),
the configs (``config.py``), ``load_torch_resnet`` (``models/resnet.py``)
and the debug hooks (``train/debug.py``).

Models: the ViT (hidden 32, 1 block, 4 heads), the Martinez lifter
(hidden 64, 2 stages, BatchNorm) and the AE (hidden 64), the last two
with dropout 0 where held to JAX (their masks cannot match JAX's), BN
in train mode; seeded biases, BN scales and statistics
(``torch_port_util``); B = 8; AdamW (weight decay 1e-2) at lr 2^-10,
exact in f32 and f64 (the JAX step takes its lr from the f32 plateau
state).

Tolerances, float64 on both sides (x64 on): three consecutive train
steps, and a 3-batch epoch: the loss (and the epoch's last-batch loss and
MPJPE sums) rtol 1e-10, the parameters after each step atol 1e-8 (Adam's
first step is -lr·g/(|g| + eps): a gradient near eps moves by up to
lr·δg/eps), the BatchNorm running mean and (unbiased) variance atol
1e-10; the eval epoch with and without flip TTA: loss and MPJPE sums
rtol 1e-10, the eval step's prediction atol 1e-12.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from torch_port_util import _seeded_norms, flax_bn_lifter, flax_vit, torch_bn_lifter, torch_vit

from pose3d_tpu_torch import config
from pose3d_tpu_torch.cli import train_lift as cli
from pose3d_tpu_torch.models.lifters import MartinezLifter
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train import debug
from pose3d_tpu_torch.train.epoch import make_lifter_epoch_fn, make_lifter_eval_epoch_fn
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_eval_step, make_lifter_train_step

torch.set_num_threads(2)

LR = 2.0 ** -10
B = 8
FIELDS = {"vit": {"hidden": 32, "heads": 4, "n_blocks": 1},
          "martinez": {"hidden": 64, "num_stages": 2, "dropout": 0.0},
          "ae": {"hidden": 64, "dropout": 0.0}}
KINDS = sorted(FIELDS)


@functools.cache
def _weights(kind):
    """(flax module class fields, params, batch_stats) as f32 numpy."""
    if kind == "vit":
        _, params = flax_vit(seed=0, **FIELDS[kind])
        return _seeded_norms(params, np.random.default_rng(100), False), {}
    _, params, stats = flax_bn_lifter(kind, seed=0, **FIELDS[kind])
    return params, stats


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((n, B, 17, 2)), 0.3 * rng.standard_normal((n, B, 17, 3)))


def _jax_state(kind):
    """A float64 JAX TrainState of ``kind`` holding ``_weights(kind)``;
    call inside ``jax.enable_x64(True)``."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.lifters import AELifter, JointTransformerLifter, MartinezLifter
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    cls = {"vit": JointTransformerLifter, "martinez": MartinezLifter, "ae": AELifter}[kind]
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                     for t in _weights(kind))
    tx = make_optimizer(LR, "adamw")
    return TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                      opt_state=tx.init(params), plateau=plateau_init(LR), tx=tx,
                      apply_fn=cls(**FIELDS[kind], dtype=jnp.float64).apply)


def _port_state(kind):
    params, stats = _weights(kind)
    if kind == "vit":
        model = torch_vit(params, **FIELDS[kind])
    else:
        model = torch_bn_lifter(kind, params, stats, **FIELDS[kind])
    return create_train_state(model.double(), lr=LR)


def _jax_sd(kind, state) -> dict:
    """A JAX state's params (and batch stats) as the port's state dict."""
    import jax

    from pose3d_tpu_torch.interop import weights

    params = jax.tree.map(np.asarray, state.params)
    if kind == "vit":
        sd = weights.vit_lifter_from_flax(params)
    else:
        bridge = {"martinez": weights.martinez_lifter_from_flax,
                  "ae": weights.ae_lifter_from_flax}[kind]
        sd = bridge(params, jax.tree.map(np.asarray, state.batch_stats))
    return {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


def _assert_state_close(kind, model, want: dict):
    got = model.state_dict()
    for name, w in want.items():
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got[name].numpy(), w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
def test_f64_train_steps_match_the_jax_steps(kind):
    """Three consecutive steps: loss, MPJPE sums, parameters and running
    statistics after each."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.steps import make_lifter_train_step as jax_step

    y1, y2 = _batches(3, seed=1)
    state = _port_state(kind)
    step = make_lifter_train_step("mse")
    with jax.enable_x64(True):
        js = _jax_state(kind)
        jstep = jax_step("mse", donate=False)
        for i in range(3):
            js, jm = jstep(js, jnp.asarray(y1[i]), jnp.asarray(y2[i]), jax.random.key(i))
            m = step(state, torch.from_numpy(y1[i]), torch.from_numpy(y2[i]))
            np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-10)
            np.testing.assert_allclose(m["mpjpe_sums"].numpy(), np.asarray(jm["mpjpe_sums"]),
                                       rtol=1e-10)
            _assert_state_close(kind, state.model, _jax_sd(kind, js))
    assert state.step == 3 and state.model.training


@pytest.mark.parametrize("kind", KINDS)
def test_f64_epoch_matches_the_jax_epoch(kind):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.epoch import make_lifter_epoch_fn as jax_epoch

    y1, y2 = _batches(3, seed=2)
    state = _port_state(kind)
    m = make_lifter_epoch_fn("mse")(state, torch.from_numpy(y1), torch.from_numpy(y2), 0)
    with jax.enable_x64(True):
        js, jm = jax_epoch("mse", donate=False)(_jax_state(kind), jnp.asarray(y1),
                                                jnp.asarray(y2), jax.random.key(0))
        want = _jax_sd(kind, js)
    assert set(m) == set(jm) == {"loss", "last_batch_loss", "mpjpe_sums"}
    for k in m:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-10, err_msg=k)
    assert state.step == 3
    _assert_state_close(kind, state.model, want)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_f64_eval_epoch_matches_the_jax_eval_epoch(kind, flip):
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.epoch import make_lifter_eval_epoch_fn as jax_eval
    from pose3d_tpu.train.steps import make_lifter_eval_step as jax_step

    y1, y2 = _batches(2, seed=3)
    state = _port_state(kind)
    m = make_lifter_eval_epoch_fn("mse", flip_tta=flip)(state, torch.from_numpy(y1),
                                                         torch.from_numpy(y2))
    pred = make_lifter_eval_step("mse", flip_tta=flip)(
        state, torch.from_numpy(y1[0]), torch.from_numpy(y2[0]))["pred"]
    with jax.enable_x64(True):
        js = _jax_state(kind)
        jm = jax_eval("mse", flip_tta=flip)(js, jnp.asarray(y1), jnp.asarray(y2))
        jpred = jax_step("mse", flip_tta=flip)(js, jnp.asarray(y1[0]), jnp.asarray(y2[0]))["pred"]
    assert not state.model.training
    for k in ("loss", "mpjpe_sums"):
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-10, err_msg=k)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-12, rtol=0)


def test_flip_tta_averages_the_flipped_prediction_flipped_back():
    """The documented intent, not the reference's operand bug: pred =
    (flip(f(flip(x))) + f(x)) / 2."""
    from pose3d_tpu_torch.core.transforms import flip_pose

    state = _port_state("vit")
    y1, y2 = (torch.from_numpy(a[0]) for a in _batches(1, seed=4))
    pred = make_lifter_eval_step("mse", flip_tta=True)(state, y1, y2)["pred"]
    with torch.no_grad():
        want = (flip_pose(state.model(flip_pose(y1))) + state.model(y1)) / 2
    torch.testing.assert_close(pred, want, rtol=0, atol=0)


def _dropout_state():
    model = MartinezLifter(hidden=64, device="cpu").init_weights(torch.Generator().manual_seed(0))
    return create_train_state(model, lr=1e-3)


def test_dropout_masks_come_from_the_epoch_seed():
    """Two runs of one seed bitwise equal; another seed, other masks; the
    caller's generator state is left as it was."""
    y1, y2 = (torch.from_numpy(a).float() for a in _batches(3, seed=5))
    epoch = make_lifter_epoch_fn("mse")
    runs = []
    for seed in (7, 7, 8):
        state = _dropout_state()
        before = torch.get_rng_state()
        m = epoch(state, y1, y2, seed)
        assert torch.equal(torch.get_rng_state(), before)
        runs.append((m["loss"], state.model.state_dict()))
    for k, v in runs[0][1].items():
        assert torch.equal(runs[1][1][k], v), k
    assert runs[0][0] != runs[2][0]
    assert not torch.equal(runs[0][1]["w2.weight"], runs[2][1]["w2.weight"])


def test_mesh_epochs_are_not_ported():
    """Mesh epochs are ported now (``tests/test_torch_parallel.py`` runs
    them over spawned ranks); given a mesh and no process group, the
    epoch raises before any step instead of running as one process."""
    state = _port_state("vit")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    y1, y2 = _batches(1, seed=1)
    with pytest.raises(RuntimeError, match="no process group"):
        make_lifter_epoch_fn("mse", mesh=object())(state, torch.from_numpy(y1),
                                                    torch.from_numpy(y2), 0)
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def _cfg(tmp_path, **kw):
    base = {"n_epochs": 2, "device": "cpu", "log_dir": str(tmp_path), "run_name": "l",
            "data": config.DataConfig(action="Posing", synthetic_frames=256)}
    base.update(kw)
    return config.LiftConfig(**base)


@pytest.mark.parametrize("model", ["vit", "martinez", "ae"])
def test_cli_trains_each_lifter(tmp_path, model):
    state = cli.train(_cfg(tmp_path, model=model, n_epochs=1, flip=True))
    assert state.step == 256 // 64
    records = [json.loads(line) for line in (tmp_path / "runs" / "l.jsonl").read_text()
               .splitlines()]
    assert records[0]["architecture"] == model and records[-1]["event"] == "finish"
    epochs = [r for r in records if "epoch" in r]
    assert len(epochs) == 1
    assert all(np.isfinite(epochs[0][k]) for k in ("train_loss", "train_mpjpe", "val_loss",
                                                   "val_mpjpe"))
    assert ckpt.load_meta(tmp_path, "l") == {"batch_size": 64, "model": model}
    assert (tmp_path / "run_time_utils" / "mean_train_2d.npy").exists()


def test_cli_checkpoints_and_resumes(tmp_path):
    state = cli.train(_cfg(tmp_path, model="martinez"))
    assert state.step == 2 * (256 // 64)
    fresh = cli.train(_cfg(tmp_path, model="martinez", n_epochs=0, resume=True))
    assert fresh.step == state.step
    for name, p in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], p), name
    saved = state.optimizer.state_dict()["state"]
    for k, st in fresh.optimizer.state_dict()["state"].items():
        assert torch.equal(st["exp_avg_sq"], saved[k]["exp_avg_sq"])
    assert fresh.plateau.state_dict() == state.plateau.state_dict()
    more = cli.train(_cfg(tmp_path, model="martinez", n_epochs=1, resume=True))
    assert more.step == state.step + 256 // 64


def test_cli_runs_are_reproducible(tmp_path):
    """One config, two runs on the CPU: bitwise equal parameters (the
    Martinez lifter's dropout masks included)."""
    a = cli.train(_cfg(tmp_path / "a", model="martinez"))
    b = cli.train(_cfg(tmp_path / "b", model="martinez"))
    for name, p in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[name], p), name


def test_cli_saves_an_interrupt_checkpoint(tmp_path, monkeypatch):
    def interrupted(loss):
        def epoch(*args):
            raise KeyboardInterrupt
        return epoch

    monkeypatch.setattr(cli, "make_lifter_epoch_fn", interrupted)
    with pytest.raises(KeyboardInterrupt):
        cli.train(_cfg(tmp_path))
    assert ckpt.exists(tmp_path, "interrupt_l") and not ckpt.exists(tmp_path, "l")
    with pytest.raises(KeyboardInterrupt):
        cli.train(_cfg(tmp_path, run_name="m", ctlc_save=False))
    assert not ckpt.exists(tmp_path, "interrupt_m")


def test_cli_reads_a_human36m_tree(tmp_path):
    """``data.data_dir`` set to a fabricated export: the splits are the
    reader's frames of the configured subjects and action, and the
    training statistics land under ``run_time_utils``."""
    from torch_port_util import write_fake_h36m

    from pose3d_tpu_torch.data import h36m

    frames = {("S1", "Posing"): 40, ("S1", "Walking"): 24, ("S5", "Posing 1"): 16}
    write_fake_h36m(tmp_path / "h36m", frames, np.random.default_rng(6))
    data = config.DataConfig(data_dir=str(tmp_path / "h36m"), action="Posing",
                             train_subjects=("S1",), test_subjects=("S5",))
    cfg = _cfg(tmp_path, batch_size=8, n_epochs=1, data=data)
    train_ds, val_ds = cli.load_split(cfg, True), cli.load_split(cfg, False)
    assert len(train_ds) == len(h36m.read_data(data.data_dir, ("S1",), "Posing")[1]) == 40
    assert len(val_ds) == 16
    state = cli.train(cfg)
    assert state.step == 40 // 8
    assert sorted(p.name for p in (tmp_path / "run_time_utils").iterdir()) == [
        "max_train_3d.npy", "mean_train_2d.npy", "mean_train_3d.npy", "min_train_3d.npy",
        "std_train_2d.npy", "std_train_3d.npy"]


def test_cli_renders_the_validation_poses_as_jax_draws_them(tmp_path, monkeypatch):
    """The end-of-run renders: ``3d_test_a.png`` and ``3d_test_b.png``, the
    first and last pose of the first validation batch, ground truth against
    prediction, byte for byte JAX's ``visualize_3d`` of the same poses."""
    from pose3d_tpu.utils.visualize import visualize_3d as jax_visualize_3d

    from pose3d_tpu_torch.utils import visualize

    drawn = []
    port_visualize_3d = visualize.visualize_3d

    def recording(gt, pred, path):
        drawn.append((gt, pred, path))
        port_visualize_3d(gt, pred, path)

    monkeypatch.setattr(visualize, "visualize_3d", recording)
    state = cli.train(_cfg(tmp_path, n_epochs=1))
    out = tmp_path / "visualizations" / "l"
    assert [p for _, _, p in drawn] == [out / "3d_test_a.png", out / "3d_test_b.png"]
    vy1, vy2 = (torch.from_numpy(a) for a in cli.stack_batches(
        (cli.load_split(_cfg(tmp_path), False).kp2d, cli.load_split(_cfg(tmp_path), False).kp3d),
        64))
    with torch.no_grad():
        pred = state.model.eval()(vy1[0]).reshape(64, 17, 3).numpy()
    for (gt, p, path), i in zip(drawn, (0, -1)):
        np.testing.assert_array_equal(gt, vy2[0][i].numpy())
        np.testing.assert_array_equal(p, pred[i])
        jax_visualize_3d(gt, p, tmp_path / "jax.png")
        assert path.read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_cli_carries_on_without_matplotlib(tmp_path, monkeypatch, capsys):
    """A host without matplotlib (the GPU host) trains, saves and says that
    it drew nothing."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli.train(_cfg(tmp_path, n_epochs=1))
    assert "visualization skipped:" in capsys.readouterr().out
    assert ckpt.exists(tmp_path, "l") and not (tmp_path / "visualizations" / "l").exists()


class _FakeWandb:
    """What the logger calls of wandb, recorded."""

    def __init__(self, fail_init=False):
        self.calls, self.fail_init = [], fail_init

    def init(self, **kw):
        if self.fail_init:
            raise RuntimeError("no network")
        self.calls.append(("init", kw))

    def log(self, record):
        self.calls.append(("log", record))

    def finish(self):
        self.calls.append(("finish",))


def _log_run(logger_cls, log_dir, **kw):
    logger = logger_cls(log_dir, "run", config={"lr": 1e-3}, **kw)
    logger.log_epoch(0, 2, 0.5, 120.0, 0.25, 130.0, lr=1e-3)
    logger.finish()


def test_metric_logger_mirrors_to_wandb_as_jax_does(tmp_path, monkeypatch):
    """``WANDB=1`` with a (fake) wandb importable: the JAX logger's calls,
    the reference's keys (the val MPJPE key's leading space kept)."""
    import sys

    from pose3d_tpu.train.logging import MetricLogger as JaxLogger

    from pose3d_tpu_torch.train.logging import MetricLogger

    monkeypatch.setenv("WANDB", "1")
    calls = {}
    for name, cls in (("port", MetricLogger), ("jax", JaxLogger)):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        _log_run(cls, tmp_path / name)
        calls[name] = fake.calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][1] == ("log", {"loss(train)": 0.5, "loss(val.)": 0.25,
                                        "MPJPE(train)": 120.0, " MPJPE(val.)": 130.0})
    assert MetricLogger.WANDB_KEYS == JaxLogger.WANDB_KEYS


def test_metric_logger_runs_without_wandb(tmp_path, monkeypatch, capsys):
    """No ``WANDB=1``: no call; ``WANDB=1`` where wandb does not import or
    its init fails: the run goes on without the mirror, the JSONL complete."""
    import sys

    from pose3d_tpu_torch.train.logging import MetricLogger

    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.delenv("WANDB", raising=False)
    _log_run(MetricLogger, tmp_path / "off")
    assert fake.calls == []
    _log_run(MetricLogger, tmp_path / "asked", use_wandb=True)
    assert [c[0] for c in fake.calls] == ["init", "log", "finish"]
    monkeypatch.setenv("WANDB", "1")
    for i, module in enumerate((None, _FakeWandb(fail_init=True))):
        monkeypatch.setitem(sys.modules, "wandb", module)
        _log_run(MetricLogger, tmp_path / f"failed{i}")
        records = (tmp_path / f"failed{i}" / "runs" / "run.jsonl").read_text().splitlines()
        assert [json.loads(r).get("event", "epoch") for r in records] == ["config", "epoch",
                                                                        "finish"]
    assert capsys.readouterr().out.count("wandb mirror off") == 2


def test_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would train on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.train(_cfg(tmp_path, device="cuda"))


def test_cli_passes_grad_clip_to_the_state(tmp_path):
    state = cli.train(_cfg(tmp_path, n_epochs=0, grad_clip=1.5))
    assert state.grad_clip == 1.5


def test_parse_lift_config():
    cfg = config.parse_config(config.LiftConfig, [
        "--cpu", "--model", "martinez", "--flip", "true", "--data.split_rate", "50",
        "--data.train_subjects", "S1,S5", "--grad_clip", "1.0"])
    assert cfg.device == "cpu" and cfg.model == "martinez" and cfg.flip is True
    assert cfg.data.split_rate == 50 and cfg.data.train_subjects == ("S1", "S5")
    assert cfg.data.action == "Posing" and cfg.grad_clip == 1.0  # the preset kept
    assert config.parse_config(config.LiftConfig, []).device == "cuda"
    direct = config.parse_config(config.DirectConfig, ["--data.synthetic_frames", "32"])
    assert (direct.data.action, direct.data.split_rate, direct.data.synthetic_frames) == (
        "1.6", 50, 32)


@pytest.mark.parametrize("name", ["DataConfig", "LiftConfig", "DirectConfig"])
def test_config_fields_and_defaults_equal_jax(name):
    """Every field of the JAX config with its default; the port adds
    ``device``."""
    from pose3d_tpu import config as jc

    got, want = getattr(config, name)(), getattr(jc, name)()
    got_fields = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
    want_fields = {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    if name != "DataConfig":
        assert got_fields.pop("device") == "cuda"
        got_fields["data"] = dataclasses.asdict(got_fields["data"])
        want_fields["data"] = dataclasses.asdict(want_fields["data"])
    assert got_fields == want_fields


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_load_torch_resnet_counts_as_jax_and_skips_mismatches(arch):
    """A seeded torchvision-layout state dict with the classifier and one
    entry of a wrong shape: the count equals the JAX merge's, every
    matching entry is copied, the rest keep the model's values."""
    import jax

    from pose3d_tpu.models.resnet import ResNet as JaxResNet
    from pose3d_tpu.models.resnet import load_torch_resnet as jax_load
    from pose3d_tpu_torch.models.resnet import ResNet, load_torch_resnet

    model = ResNet(arch, device="cpu")
    own = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point() else v + 3)
          for k, v in own.items()}
    width = model.feature_channels
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, width), torch.randn(1000)
    sd["layer1.0.conv1.weight"] = torch.randn(7, 7, 1, 1)
    n = load_torch_resnet(model, sd)

    jmodel = JaxResNet(architecture=arch)
    variables = jax.jit(lambda k: jmodel.init(k, np.zeros((1, 32, 32, 3), np.float32)))(
        jax.random.key(0))
    _, _, jn = jax_load(variables["params"], variables["batch_stats"],
                        {k: v.numpy() for k, v in sd.items()})
    counters = sum(k.endswith("num_batches_tracked") for k in sd)
    assert n == jn == len(sd) - counters - 3
    got = model.state_dict()
    for k, v in got.items():
        if k == "layer1.0.conv1.weight" or k.endswith("num_batches_tracked"):
            assert torch.equal(v, own[k]), k
        else:
            assert torch.equal(v, sd[k]), k


def test_assert_finite_warns_with_the_name_and_returns_the_tensor():
    x = torch.tensor([1.0, float("nan")])
    with pytest.warns(RuntimeWarning, match="logits"):
        assert debug.assert_finite(x, "logits") is x
    y = torch.ones(3)
    assert debug.assert_finite(y) is y


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_nan_check_mode_raises_at_the_first_non_finite_value(where):
    if where == "forward":
        layer = torch.nn.Linear(2, 2)
        with torch.no_grad():
            layer.weight[0, 0] = float("nan")
        with debug.nan_check_mode(), pytest.raises(FloatingPointError, match="Linear"):
            layer(torch.ones(1, 2))
    else:
        x = torch.zeros(1, requires_grad=True)
        with debug.nan_check_mode(), pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0).sum().backward()  # 0 · inf in the backward
    with debug.nan_check_mode(False):  # off: nothing checks
        (torch.sqrt(torch.zeros(1, requires_grad=True)) * 0).sum().backward()


def test_step_timer_reports_once_a_window():
    timer = debug.StepTimer(window=3)
    out = [timer.tick({"loss": torch.zeros(())}, batch_size=4) for _ in range(7)]
    assert out[0] is None and out[1:3] == [None, None] and out[4:6] == [None, None]
    for stats in (out[3], out[6]):
        assert stats["steps_per_s"] > 0 and stats["items_per_s"] > 0


def test_profile_traces_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv("POSE3D_PROFILE", raising=False)
    with debug.profile():
        torch.ones(4).sum()
    monkeypatch.setenv("POSE3D_PROFILE", str(tmp_path / "trace"))
    with debug.profile():
        torch.ones(4).sum()
    assert any((tmp_path / "trace").iterdir())
