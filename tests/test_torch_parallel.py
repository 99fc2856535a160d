"""The port's data-parallel layer (``pose3d_tpu_torch/parallel/mesh.py``)
and its stats-free steps, on the CPU over spawned ``gloo`` ranks
(``torch_dist_util.spawn``; the ranks import no JAX).

- The mesh: names, shapes, the 2 x 2 mesh and its error, ``shard_batch``'s
  row order (JAX's ``P(DATA_AXIS)``), ``psum_`` / ``pmean_`` (exact on
  these values), ``broadcast_parameters``, the bitwise replication check;
  a DP step whose process group is gone raises; without a launcher there
  is no mesh and the one-process paths run as before.
- ``make_dp_lifter_train_step`` and ``make_lifter_epoch_fn(mesh=)`` on a
  TemporalLifter (hidden 64, 4 heads, 1 block, 8 frames; the module's
  forward), SGD at lr 1e-3 (the step is linear in the gradients, so
  Adam's sign flips cannot hide an error), a skewed batch of 4 clips over
  2 ranks (each clip scaled by its index, so a missing ``pmean`` or a sum
  where a mean belongs cannot cancel): against the port's one-process
  step on the global batch and against JAX's ``make_dp_lifter_train_step``
  / mesh epoch on a 2-device mesh. Tolerances, f32 (the JAX mesh suite's):
  loss rtol 1e-6 (the epoch's 1e-5, three compounding steps), MPJPE sums
  rtol 1e-5, parameters atol 1e-6 + rtol 1e-5 (the epoch's 1e-5 + 1e-5);
  both ranks' parameters bitwise equal. The step on the fused training
  apply (``temporal_train_forward_fused``, its plain versions on the CPU;
  hidden 256, 8 heads, 4 frames) against the one-process step on it, at
  the same limits. The DP step's ``ValueError`` on a BatchNorm model, and
  ``make_lifter_train_step(mesh=)``'s on one whose BatchNorms are unbound.
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import assert_ranks_bitwise_equal, spawn
from torch_port_util import flax_temporal, torch_temporal

from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax
from pose3d_tpu_torch.parallel import mesh as M
from pose3d_tpu_torch.train.epoch import make_lifter_epoch_fn
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_train_step

torch.set_num_threads(2)

FIELDS = {"clip_len": 8, "n_blocks": 1, "hidden": 64, "heads": 4}
B = 4  # 2 clips a rank
LR = 1e-3


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_and_collectives(tmp_path, world):
    batch = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    res = spawn(cases.mesh_checks, world, tmp_path, batch)
    for r, out in enumerate(res):
        assert out["rank"] == r
        assert out["names"] == (M.DATA_AXIS, M.MODEL_AXIS) == ("data", "model")
        assert out["shape"] == (world, 1)
        assert "3" in out["error"] and "1" in out["error"] and str(world) in out["error"]
        n_data = 2 if world == 4 else world
        d = out["data_rank_2x2"] if world == 4 else r
        if world == 4:
            assert out["shape_2x2"] == (2, 2) and d == r // 2
        rows = 8 // n_data
        np.testing.assert_array_equal(out["shard"], batch[d * rows:(d + 1) * rows])
        np.testing.assert_array_equal(out["shard_pair"], batch[d * rows:(d + 1) * rows])
        # the data axis of the 2 x 2 mesh joins ranks r and r ± 2
        group = [q for q in range(world) if world != 4 or q % 2 == r % 2]
        x, y = out["psum"]
        want = sum(q + 1 for q in group)
        np.testing.assert_array_equal(x, [want, 2.0 ** -30 * want])
        np.testing.assert_array_equal(y, np.full(3, sum(group), np.float32))
        np.testing.assert_array_equal(out["pmean"], [np.mean(group)])
        src = 0 if world != 4 else r % 2
        np.testing.assert_array_equal(out["broadcast"], np.full((2, 3), float(src)))
        assert (out["replication_error"] is None) == (r == 0), out["replication_error"]
        bn = out["bn"]
        assert "local; bind them" in bn["global_step_local_model"]
        assert "local; bind them" in bn["loop_step_local_models"]
        assert "wants them local" in bn["local_step_global_model"]
        assert bn["bound_group_size"] == n_data and bn["unbound"]
        _assert_bf16_global_bn(bn["bf16"], d, n_data)


def _assert_bf16_global_bn(got: dict, d: int, n_data: int) -> None:
    """The global BatchNorm in bf16 on data rank d's rows against PyTorch's
    train-mode batch norm (its mixed-precision kernel, f32 inside) on the
    whole batch in one process: the output and the input gradient within
    2 bf16 ulps of the largest (both compute in f32 and round once; the
    sums run in other orders), the f32 weight, bias and running-statistic
    values at f32 precision."""
    x, bn, g = cases.bf16_bn_inputs()
    x = x.detach().requires_grad_(True)
    y = bn.train()(x)
    (y.float() * g.float()).sum().backward()
    rows = slice(d * 8 // n_data, (d + 1) * 8 // n_data)
    assert got["dtypes"] == ("torch.bfloat16", "torch.bfloat16") and got["channels_last"]
    for name, want in (("y", y.detach()), ("dx", x.grad)):
        want = want.float().numpy()
        np.testing.assert_allclose(got[name], want[rows], rtol=0,
                                   atol=2 * 2.0 ** -8 * np.abs(want).max(), err_msg=name)
    np.testing.assert_allclose(got["dw"], bn.weight.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["db"], bn.bias.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["running"][0], bn.running_mean.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["running"][1], bn.running_var.numpy(), rtol=1e-5, atol=1e-6)


def test_no_launcher_no_mesh():
    """One process, no process group: no mesh can be made, the one-process
    step runs as before."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        M.make_mesh()
    M.check_replicated([torch.zeros(3)])  # a no-op for one process
    assert M.is_writer()
    state = create_train_state(torch.nn.Linear(2, 3), lr=LR, optimizer="sgd")
    m = make_lifter_train_step()(state, torch.ones(4, 2), torch.zeros(4, 3))
    assert state.step == 1 and np.isfinite(m["loss"].item())


def _skewed(rng, n, clip_len, *lead):
    y1 = rng.random((*lead, n, clip_len, 17, 2)) * np.arange(1, n + 1).reshape(n, 1, 1, 1)
    y2 = rng.random((*lead, n, clip_len, 17, 3)) - 0.5
    return y1.astype(np.float32), y2.astype(np.float32)


def _port_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _close(got: dict, want: dict, atol, rtol):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=rtol, err_msg=name)


@pytest.fixture(scope="module")
def lifter_runs(tmp_path_factory):
    """The ranks' DP runs, the port's one-process runs and JAX's DP runs
    on a 2-device mesh, from one set of flax weights."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter
    from pose3d_tpu.parallel.mesh import make_mesh
    from pose3d_tpu.train.epoch import make_lifter_epoch_fn as jax_epoch
    from pose3d_tpu.train.state import create_train_state as jax_state
    from pose3d_tpu.train.steps import make_dp_lifter_train_step as jax_dp_step

    _, params = flax_temporal(seed=0, **FIELDS)
    sd = {k: v.numpy() for k, v in temporal_lifter_from_flax(params).items()}
    rng = np.random.default_rng(0)
    y1, y2 = _skewed(rng, B, FIELDS["clip_len"])
    y1e, y2e = _skewed(rng, B, FIELDS["clip_len"], 3)
    _, fparams = flax_temporal(seed=1, clip_len=4, n_blocks=1)
    fsd = {k: v.numpy() for k, v in temporal_lifter_from_flax(fparams).items()}
    fy1, fy2 = _skewed(rng, B, 4)
    ranks = spawn(cases.dp_lifter, 2, tmp_path_factory.mktemp("dp_lifter"), FIELDS, sd,
                  y1, y2, y1e, y2e, fsd, fy1, fy2)

    one = {}
    s = create_train_state(torch_temporal(params, **FIELDS), lr=LR, optimizer="sgd")
    m = make_lifter_train_step()(s, torch.from_numpy(y1), torch.from_numpy(y2))
    one["step"] = {"loss": m["loss"].item(), "sums": m["mpjpe_sums"].numpy(),
                   "params": _port_sd(s.model)}
    s = create_train_state(torch_temporal(params, **FIELDS), lr=LR, optimizer="sgd")
    m = make_lifter_epoch_fn()(s, torch.from_numpy(y1e), torch.from_numpy(y2e), 5)
    one["epoch"] = {"loss": m["loss"].item(), "last": m["last_batch_loss"].item(),
                    "sums": m["mpjpe_sums"].numpy(), "params": _port_sd(s.model)}
    from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused

    s = create_train_state(torch_temporal(fparams, clip_len=4, n_blocks=1), lr=LR,
                           optimizer="sgd", apply=temporal_train_forward_fused)
    m = make_lifter_train_step()(s, torch.from_numpy(fy1), torch.from_numpy(fy2))
    one["fused"] = {"loss": m["loss"].item(), "sums": m["mpjpe_sums"].numpy(),
                    "params": _port_sd(s.model)}

    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    js = jax_state(TemporalLifter(**FIELDS), jax.random.key(0),
                   jnp.zeros((B, FIELDS["clip_len"], 17, 2)), lr=LR, optimizer="sgd")
    js = js.replace(params=params, opt_state=js.tx.init(params))
    jax_runs = {}
    j2, jm = jax_dp_step(mesh, donate=False)(js, jnp.asarray(y1), jnp.asarray(y2),
                                             jax.random.key(1))
    jax_runs["step"] = (jm, j2.params)
    j2, jm = jax_epoch(donate=False, mesh=mesh)(js, jnp.asarray(y1e), jnp.asarray(y2e),
                                                jax.random.key(5))
    jax_runs["epoch"] = (jm, j2.params)
    jax_runs = {k: (jax.tree.map(np.asarray, m), {n: v.numpy() for n, v in
                    temporal_lifter_from_flax(jax.tree.map(np.asarray, p)).items()})
                for k, (m, p) in jax_runs.items()}
    return ranks, one, jax_runs


@pytest.mark.parametrize("what", ["step", "epoch", "fused"])
def test_dp_lifter_matches_the_one_process_step(lifter_runs, what):
    ranks, one, _ = lifter_runs
    assert_ranks_bitwise_equal([r[what] for r in ranks], "params")
    got, want = ranks[0][what], one[what]
    loss_rtol, p_atol = (1e-5, 1e-5) if what == "epoch" else (1e-6, 1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    assert ranks[1][what]["loss"] == got["loss"]
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=1e-5)
    _close(got["params"], want["params"], p_atol, 1e-5)


@pytest.mark.parametrize("what", ["step", "epoch"])
def test_dp_lifter_matches_jax(lifter_runs, what):
    ranks, _, jax_runs = lifter_runs
    jm, jparams = jax_runs[what]
    got = ranks[0][what]
    loss_rtol, p_atol = (1e-5, 1e-5) if what == "epoch" else (1e-6, 1e-6)
    np.testing.assert_allclose(got["loss"], float(jm["loss"]), rtol=loss_rtol)
    if what == "epoch":
        np.testing.assert_allclose(got["last"], float(jm["last_batch_loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(got["sums"], np.asarray(jm["mpjpe_sums"]), rtol=1e-5)
    _close(got["params"], jparams, p_atol, 1e-5)
