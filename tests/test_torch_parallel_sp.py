"""Sequence parallelism in the port (``TemporalLifter(activation_spec=
("data", "model", None, None))`` bound by
``parallel.sharding.sequence_parallel``) on the CPU over spawned ``gloo``
ranks (``torch_dist_cases.sp_ranks``; the ranks import no JAX), against
JAX's ``make_lifter_train_step`` on a ``TemporalLifter`` with the same
``activation_spec`` on the conftest's virtual devices, and against the
port's one process.

The configuration: clips of 16 frames (8 a model rank), hidden 32, two
blocks, 2 heads, 4 clips, AdamW at 1e-3, two steps, flash off and on.
On a 1 x 2 and a 2 x 2 mesh:

- float64 against the one-process step on the global batch: losses, MPJPE
  sums and every parameter within 1e-12 (the sums of the split frames
  taken in another order); the same with ``grad_clip`` set where it binds
  (the clip reads the whole gradient); every rank's parameters bitwise
  equal.
- f32 against JAX's GSPMD step: the losses within rtol 1e-5, each
  parameter within atol 1e-5 + rtol 1e-5 or, where the port's one-process
  f32 step is itself outside that, at most twice as far from JAX as it is
  (AdamW turns f32 rounding noise of a gradient near 0 into moves of up
  to lr, in both packages' one-device steps). The key columns of each qkv
  bias (``KEY_BIAS``) have an exact gradient of 0 (a bias on every key
  adds the same q·b to each score of a row, which the softmax cancels),
  so each f32 run moves them by its own noise, up to lr a step: they are
  held in float64 above, and in f32 only to that bound.
- a clip whose frames do not split over the model axis, and the kernel
  route, raise ValueError.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import spawn
from torch_port_util import flax_temporal

from pose3d_tpu_torch.data.synthetic import synthetic_h36m
from pose3d_tpu_torch.interop import weights as W
from pose3d_tpu_torch.models.temporal import TemporalLifter, check_activation_spec, make_clips

torch.set_num_threads(2)

F32_ATOL = F32_RTOL = 1e-5
F64_TOL = 1e-12
CLIPS = 4
DIM = cases.SP_FIELDS["hidden"]
KEY_BIAS = slice(DIM, 2 * DIM)  # the key columns of a qkv bias: exact gradient 0
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


def _batch():
    t = cases.SP_FIELDS["clip_len"]
    kp2d, kp3d = synthetic_h36m(t * CLIPS, seed=4)
    return (make_clips(kp2d, t).astype(np.float32),
            make_clips(kp3d - kp3d[:, :1], t).astype(np.float32))


def _jax_sp(params, y1, y2, n_data: int, n_model: int) -> dict:
    """JAX's step on an n_data x n_model mesh with ``activation_spec``, f32:
    losses and the bridged state dict."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.temporal import TemporalLifter as FlaxLifter
    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pose3d_tpu.train.state import create_train_state
    from pose3d_tpu.train.steps import make_lifter_train_step

    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    lifter = FlaxLifter(**cases.SP_FIELDS, activation_spec=cases.SP_SPEC)
    losses = []
    with jax.sharding.set_mesh(mesh):
        state = create_train_state(lifter, jax.random.key(0), jnp.zeros(y1.shape), lr=cases.SP_LR)
        p = jax.tree.map(jnp.asarray, params)
        state = jax.device_put(state.replace(params=p, opt_state=state.tx.init(p)),
                               replicated(mesh))
        x, y = (jax.device_put(jnp.asarray(a), batch_sharding(mesh)) for a in (y1, y2))
        step = make_lifter_train_step(loss="mse", donate=False)
        for i in range(cases.SP_STEPS):
            state, m = step(state, x, y, jax.random.key(i))
            losses.append(float(m["loss"]))
        sd = W.temporal_lifter_from_flax(jax.tree.map(np.asarray, state.params))
    return {"losses": losses, "full": {k: v.numpy() for k, v in sd.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs on both meshes, the port's one-process runs and
    JAX's, from one set of flax weights and one batch."""
    _, params = flax_temporal(seed=0, **cases.SP_FIELDS)
    sd = {k: v.numpy() for k, v in W.temporal_lifter_from_flax(params).items()}
    y1, y2 = _batch()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = {name: pool.submit(spawn, cases.sp_ranks, d * m, tmp_path_factory.mktemp(name),
                                   sd, y1, y2, m)
                 for name, (d, m) in MESHES.items()}
        jax_runs = {name: _jax_sp(params, y1, y2, d, m) for name, (d, m) in MESHES.items()}
        one = {(dtype, flash): cases.sp_run(cases.sp_state(sd, dtype, flash=flash), y1, y2)
               for dtype in ("float32", "float64") for flash in (False, True)}
        one["clip"] = cases.sp_run(cases.sp_state(sd, "float64", grad_clip=cases.SP_CLIP), y1, y2)
        ranks = {name: f.result() for name, f in ranks.items()}
    return {"ranks": ranks, "jax": jax_runs, "one": one}


def _replicated(ranks, key):
    """Every rank's state dict is rank 0's, bit for bit."""
    for r in ranks[1:]:
        for k, v in r[key]["full"].items():
            assert v.tobytes() == ranks[0][key]["full"][k].tobytes(), (r["data_rank"],
                                                                       r["model_rank"], k)


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_step_is_the_one_process_step_in_f64(runs, mesh, flash):
    ranks = runs["ranks"][mesh]
    got, want = ranks[0][("float64", flash)], runs["one"][("float64", flash)]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F64_TOL)
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=F64_TOL)
    assert set(got["full"]) == set(want["full"])
    for k, w in want["full"].items():
        np.testing.assert_allclose(got["full"][k], w, atol=F64_TOL, rtol=0, err_msg=k)
    _replicated(ranks, ("float64", flash))
    assert {(r["data_rank"], r["model_rank"]) for r in ranks} == {
        (d, m) for d in range(MESHES[mesh][0]) for m in range(MESHES[mesh][1])}


@pytest.mark.parametrize("flash", [False, True], ids=["eager", "flash"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_step_matches_jax_in_f32(runs, mesh, flash):
    got = runs["ranks"][mesh][0][("float32", flash)]
    want, one = runs["jax"][mesh], runs["one"][("float32", flash)]["full"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_RTOL)
    assert set(got["full"]) == set(want["full"])
    for k, w in want["full"].items():
        g, o = got["full"][k], one[k]
        if k.endswith("attn.qkv.bias"):
            noise = np.abs(g[KEY_BIAS] - w[KEY_BIAS]).max()
            assert noise <= 2 * cases.SP_LR * cases.SP_STEPS, (k, noise)
            g, w, o = (np.delete(a, np.arange(DIM, 2 * DIM)) for a in (g, w, o))
        if np.allclose(o, w, atol=F32_ATOL, rtol=F32_RTOL):
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=F32_RTOL, err_msg=k)
        else:
            sp, own = np.abs(g - w).max(), np.abs(o - w).max()
            assert sp <= 2 * own, (k, sp, own)
    _replicated(runs["ranks"][mesh], ("float32", flash))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_clip_reads_the_whole_gradient(runs, mesh):
    got, want = runs["ranks"][mesh][0]["clip"], runs["one"]["clip"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F64_TOL)
    for k, w in want["full"].items():
        np.testing.assert_allclose(got["full"][k], w, atol=F64_TOL, rtol=0, err_msg=k)
    free = runs["one"][("float64", False)]["full"]["head.2.weight"]
    assert np.abs(free - want["full"]["head.2.weight"]).max() > 1e-6  # it bound


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sp_refuses_what_it_cannot_split(runs, mesh):
    for r in runs["ranks"][mesh]:
        assert "do not split over 2 model ranks" in r["odd"]
        assert "use_kernels" in r["kernels"]


def test_binding_rules():
    """``sequence_parallel`` binds only a lifter whose spec splits the
    frames, once; such a lifter without a mesh raises at its forward; a
    spec the port cannot run raises at construction."""
    from pose3d_tpu_torch.parallel.sharding import sequence_parallel

    fields = {**cases.SP_FIELDS, "device": "cpu"}
    with pytest.raises(ValueError, match="splits the frames"):
        sequence_parallel(TemporalLifter(**fields), object())
    with pytest.raises(ValueError, match="splits the frames"):
        sequence_parallel(TemporalLifter(**fields, activation_spec=("data", None, None, None)),
                          object())
    model = TemporalLifter(**fields, activation_spec=cases.SP_SPEC)
    with pytest.raises(RuntimeError, match="bind a mesh"):
        model(torch.zeros(1, 4, 17, 2))
    sequence_parallel(model, "mesh")
    with pytest.raises(ValueError, match="bound to a mesh already"):
        sequence_parallel(model, "mesh")
    for bad in (("model", None, None, None), ("data", "model", "model", None), ("data",)):
        with pytest.raises(ValueError, match="activation_spec"):
            check_activation_spec(bad)
    # a spec that splits only the batch leaves the model as it is
    data_only = TemporalLifter(**fields, activation_spec=("data", None, None, None))
    data_only.init_weights(torch.Generator().manual_seed(0))
    plain = TemporalLifter(**fields)
    plain.load_state_dict(data_only.state_dict())
    x = torch.rand(1, 8, 17, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(data_only(x), plain(x))
