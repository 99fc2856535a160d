"""The port's training stack against the JAX package's, on the CPU:
losses (``pose3d_tpu_torch/losses.py``), the plateau schedule and the
optimizer (``train/schedule.py``, ``train/state.py``), one train step
(``train/steps.py``), the copied numpy tables and data
(``core/``, ``data/``), checkpoints and logs (``train/checkpoint.py``,
``train/logging.py``), the config and the temporal trainer's CLI
(``config.py``, ``cli/train_temporal.py``).

Tolerances. Losses: rtol 1e-6 (the same f32 expression). The plateau
schedule: equal learning rates and counters (the same rule; the JAX state
is f32, so rtol 1e-6 on the lr). One AdamW step (f32, lr 1e-3, the
module's forward on both sides): loss and MPJPE sums rtol 1e-5; the
parameters after the step within 1e-6 wherever the JAX gradient exceeds
1e-4 in magnitude (there Adam's first step, -lr·g/|g| - lr·wd·p, does not
feel the f32 gradient differences of ~1e-6), and within 2·lr + 1e-6
everywhere (a near-zero gradient whose sign flips moves a weight by +lr
instead of -lr).
"""

import json

import numpy as np
import pytest
import torch

from torch_port_util import flax_temporal, torch_temporal

from pose3d_tpu_torch import config, losses
from pose3d_tpu_torch.core import cameras, skeleton
from pose3d_tpu_torch.data import feed, synthetic
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.schedule import make_plateau
from pose3d_tpu_torch.train.state import create_train_state, make_optimizer
from pose3d_tpu_torch.train.steps import make_lifter_eval_step, make_lifter_train_step

torch.set_num_threads(2)

FIELDS = {"clip_len": 12, "n_blocks": 1}
LR = 1e-3


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 12, 17, 3)).astype(np.float32),
            rng.standard_normal((3, 12, 17, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["l1", "mse", "loss_mpjpe"])
def test_losses_match_jax(name):
    from pose3d_tpu import losses as jl

    a, b = _pair()
    want = np.asarray(getattr(jl, name)(a, b))
    got = getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("num_joints,zero_centred", [(17, True), (17, False), (16, True)])
def test_mpjpe_mm_matches_jax(num_joints, zero_centred):
    from pose3d_tpu import losses as jl

    sums = np.random.default_rng(1).random(17).astype(np.float32) * 50
    want = np.asarray(jl.mpjpe_mm(sums, 600, num_joints, zero_centred))
    got = losses.mpjpe_mm(torch.from_numpy(sums), 600, num_joints, zero_centred).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_plateau_matches_plateau_update():
    """A metric sequence that improves, stalls (reductions, cooldowns),
    improves by less than the threshold, and reaches min_lr."""
    from pose3d_tpu.train.schedule import plateau_init, plateau_update

    metrics = [1.0, 0.9, 0.8] + [0.8] * 6 + [0.79995] * 5 + [0.5] + [0.6] * 30
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(1))], lr=2e-5)
    sched = make_plateau(opt)
    state = plateau_init(2e-5)
    seen = set()
    for m in metrics:
        state = plateau_update(state, m)
        sched.step(m)
        lr = opt.param_groups[0]["lr"]
        seen.add(lr)
        np.testing.assert_allclose(lr, float(state.lr), rtol=1e-6)
        assert sched.num_bad_epochs == int(state.num_bad)
        assert sched.cooldown_counter == int(state.cooldown)
        assert sched.best == pytest.approx(float(state.best), rel=1e-6)
    assert min(seen) == pytest.approx(5e-6) and len(seen) >= 4  # reduced down to min_lr


@pytest.fixture(scope="module")
def steps():
    """One AdamW step of the JAX trainer and of the port on the same flax
    weights and batch, from a fresh and from a plateau-reduced lr."""
    import jax

    from pose3d_tpu.train.schedule import plateau_update
    from pose3d_tpu.train.state import create_train_state as jax_state
    from pose3d_tpu.train.steps import make_lifter_train_step as jax_step
    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax

    fmodel, params = flax_temporal(seed=0, **FIELDS)
    rng = np.random.default_rng(2)
    y1 = rng.random((2, 12, 17, 2)).astype(np.float32)
    y2 = rng.random((2, 12, 17, 3)).astype(np.float32)
    out = {}
    for reduced in (False, True):
        js = jax_state(fmodel, jax.random.key(0), y1, lr=LR)
        js = js.replace(params=params, opt_state=js.tx.init(params))
        model = torch_temporal(params, **FIELDS)
        ts = create_train_state(model, lr=LR)
        if reduced:
            for _ in range(5):  # no improvement after the first: one reduction
                js = js.replace(plateau=plateau_update(js.plateau, 1.0))
                ts.plateau.step(1.0)
        js2, jm = jax_step("mse", donate=False)(js, y1, y2, jax.random.key(1))
        jgrads = jax.grad(lambda p: ((fmodel.apply({"params": p}, y1, train=True) - y2) ** 2)
                          .mean())(params)
        tm = make_lifter_train_step("mse")(ts, torch.from_numpy(y1), torch.from_numpy(y2))
        out[reduced] = {
            "jax": (float(jm["loss"]), np.asarray(jm["mpjpe_sums"]),
                    {k: v.numpy() for k, v in temporal_lifter_from_flax(
                        jax.tree.map(np.asarray, js2.params)).items()},
                    float(js2.opt_state.hyperparams["learning_rate"])),
            "grads": {k: v.numpy() for k, v in temporal_lifter_from_flax(
                jax.tree.map(np.asarray, jgrads)).items()},
            "port": (tm["loss"].item(), tm["mpjpe_sums"].numpy(),
                     {k: v.numpy() for k, v in model.state_dict().items()}, ts.lr, ts.step),
        }
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_train_step_matches_jax(steps, reduced):
    s = steps[reduced]
    jloss, jsums, jparams, jlr = s["jax"]
    loss, sums, params, lr, n = s["port"]
    assert n == 1
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(sums, jsums, rtol=1e-5)
    # the lr the step used: written from the plateau state
    np.testing.assert_allclose(lr, jlr, rtol=1e-6)
    assert lr == pytest.approx(LR * (0.7 if reduced else 1.0))
    for name, want in jparams.items():
        diff = np.abs(params[name] - want)
        firm = np.abs(s["grads"][name]) > 1e-4
        assert diff[firm].max(initial=0) <= 1e-6, name
        assert diff.max() <= 2 * lr + 1e-6, name


def test_eval_step_has_no_grad_and_matches_the_module():
    model = torch.nn.Linear(2, 3)
    state = create_train_state(model, lr=LR)
    y1, y2 = torch.rand(4, 2), torch.rand(4, 3)
    m = make_lifter_eval_step("l1")(state, y1, y2)
    assert not m["pred"].requires_grad
    torch.testing.assert_close(m["loss"], (model(y1) - y2).abs().mean().detach())


@pytest.mark.parametrize("kind,wd,cls", [("adamw", 1e-2, torch.optim.AdamW),
                                         ("adam", 0.0, torch.optim.Adam),
                                         ("sgd", 0.0, torch.optim.SGD)])
def test_make_optimizer_defaults(kind, wd, cls):
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(2))], 1e-3, kind)
    assert type(opt) is cls and opt.param_groups[0]["weight_decay"] == wd
    with pytest.raises(ValueError):
        make_optimizer([torch.nn.Parameter(torch.zeros(2))], 1e-3, "lamb")


def test_grad_clip_matches_optax():
    import jax.numpy as jnp
    import optax

    g = np.random.default_rng(3).standard_normal(10).astype(np.float32) * 5
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g)], None)
    p = torch.nn.Parameter(torch.zeros(10))
    p.grad = torch.from_numpy(g.copy())
    from pose3d_tpu_torch.train.state import clip_by_global_norm

    clip_by_global_norm([p], 1.0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[0]), rtol=1e-6)


@pytest.mark.parametrize("name", ["CENTER", "FOCAL_LENGTH"])
def test_camera_tables_equal_the_originals(name):
    from pose3d_tpu.core import cameras as jc

    want = getattr(jc, name)
    got = getattr(cameras, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_num_joints_equals_the_original():
    from pose3d_tpu.core import skeleton as js

    assert skeleton.NUM_JOINTS == js.NUM_JOINTS


@pytest.mark.parametrize("n,seed", [(50, 0), (243, 1), (7, 6)])
def test_synthetic_h36m_equals_jax(n, seed):
    from pose3d_tpu.data import synthetic as js

    for got, want in zip(synthetic.synthetic_h36m(n, seed), js.synthetic_h36m(n, seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, True), (True, False)])
def test_batch_iterator_equals_jax(shuffle, drop):
    from pose3d_tpu.data.feed import batch_iterator

    arrays = (np.arange(23 * 2).reshape(23, 2), np.arange(23))
    kw = {"shuffle": shuffle, "seed": 4, "drop_remainder": drop, "epochs": 3}
    want = list(batch_iterator(arrays, 5, **kw))
    got = list(feed.batch_iterator(arrays, 5, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_prefetch_to_device_keeps_order():
    batches = [(np.full((2, 3), i, np.float32), np.full(2, i)) for i in range(5)]
    got = list(feed.prefetch_to_device(iter(batches), "cpu", depth=2))
    assert len(got) == 5
    for (a, b), (x, y) in zip(got, batches):
        assert isinstance(a, torch.Tensor) and torch.equal(a, torch.from_numpy(x))
        assert torch.equal(b, torch.from_numpy(y))


def test_parse_config():
    cfg = config.parse_config(config.TemporalConfig, [
        "--cpu", "--n_blocks", "1", "--use_kernels_train", "false",
        "--data.synthetic_frames", "480", "--data.data_dir", "h36m"])
    assert cfg.device == "cpu" and cfg.n_blocks == 1 and cfg.use_kernels_train is False
    assert cfg.data.synthetic_frames == 480 and cfg.data.data_dir == "h36m"
    assert cfg.clip_len == 243 and cfg.lr == 5e-4
    assert config.parse_config(config.TemporalConfig, []).device == "cuda"


def _cfg(tmp_path, **kw):
    from pose3d_tpu_torch.config import DataConfig, TemporalConfig

    base = {"clip_len": 12, "n_blocks": 1, "n_epochs": 2, "batch_size": 8, "device": "cpu",
            "log_dir": str(tmp_path), "run_name": "t",
            "data": DataConfig(synthetic_frames=240)}
    base.update(kw)
    return TemporalConfig(**base)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    from pose3d_tpu_torch.cli import train_temporal as cli

    state = cli.train(_cfg(tmp_path))
    assert state.step == 2 * (240 // 12 // 8)
    records = [json.loads(line) for line in (tmp_path / "runs" / "t.jsonl").read_text()
               .splitlines()]
    assert records[0]["event"] == "config" and records[-1]["event"] == "finish"
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert all(np.isfinite(r[k]) for r in epochs for k in ("train_loss", "val_loss"))
    assert ckpt.exists(tmp_path, "t")
    assert ckpt.load_meta(tmp_path, "t") == {"batch_size": 8, "heads": 8, "hidden": 256,
                                             "n_blocks": 1, "clip_len": 12}
    saved_opt = state.optimizer.state_dict()
    saved_plateau = state.plateau.state_dict()

    fresh = cli.train(_cfg(tmp_path, n_epochs=0, resume=True))
    assert fresh.step == state.step
    for name, p in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], p), name
    got = fresh.optimizer.state_dict()
    for k, st in saved_opt["state"].items():
        assert torch.equal(got["state"][k]["exp_avg"], st["exp_avg"])
    assert fresh.plateau.state_dict() == saved_plateau


def test_cli_reads_a_human36m_tree(tmp_path):
    """``data.data_dir`` set to a fabricated export: the clips are those of
    the JAX trainer's ``load_clips`` on the same tree (the reader's frames
    of the split's subjects and action, root-centred), bitwise; a
    ``data_dir`` that does not exist falls back to synthetic poses; the
    trainer trains on the tree."""
    from torch_port_util import write_fake_h36m

    from pose3d_tpu.cli.train_temporal import load_clips as jax_clips
    from pose3d_tpu.config import DataConfig as JaxData
    from pose3d_tpu.config import TemporalConfig as JaxConfig
    from pose3d_tpu_torch.cli import train_temporal as cli
    from pose3d_tpu_torch.config import DataConfig

    frames = {("S1", "Posing"): 50, ("S1", "Walking"): 30, ("S5", "Posing 1"): 26}
    write_fake_h36m(tmp_path / "h36m", frames, np.random.default_rng(7))
    split = {"data_dir": str(tmp_path / "h36m"), "action": "Posing",
             "train_subjects": ("S1",), "test_subjects": ("S5",)}
    cfg = _cfg(tmp_path, data=DataConfig(**split))
    jcfg = JaxConfig(clip_len=12, n_blocks=1, data=JaxData(**split))
    for is_train, n_clips in ((True, 50 // 12 + 1), (False, 26 // 12 + 1)):
        got, want = cli.load_clips(cfg, is_train), jax_clips(jcfg, is_train)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape[0] == n_clips
            np.testing.assert_array_equal(a, b)
        assert not got[1][..., 0, :].any()  # root-centred
    state = cli.train(_cfg(tmp_path, n_epochs=1, batch_size=2, data=DataConfig(**split)))
    assert state.step == 5 // 2
    missing = _cfg(tmp_path, data=DataConfig(data_dir=str(tmp_path / "absent"),
                                             synthetic_frames=240))
    c2, c3 = cli.load_clips(missing, True)
    assert c2.shape == (20, 12, 17, 2) and c3.shape == (20, 12, 17, 3)
