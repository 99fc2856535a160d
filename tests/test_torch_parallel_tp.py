"""Tensor parallelism in the port (``pose3d_tpu_torch/parallel/sharding.py``)
on the CPU over spawned ``gloo`` ranks (``torch_dist_cases.tp_four`` /
``tp_two``; the ranks import no JAX), against JAX on the conftest's
virtual devices and the port's one process:

- (i) ``infer_param_sharding`` shards the parameters JAX's rule shards,
  on the same axis, on every bridged model (Martinez, AE, ViT, temporal,
  ``PoseNet3D`` / ``PoseNet2D`` at ResNet-18, ``ProjectionMLP``,
  ``PoseSMPLNet``) at a model axis of 2; ``shard_params`` refuses the
  others, naming a layer it cannot shard.
- (ii) The 2 x 2 DP x TP Martinez step (hidden 256, one stage, dropout 0,
  global BatchNorm, a batch of 16 whose row i is scaled by i + 1, Adam at
  1e-3, three steps each followed by the plateau step) against JAX's
  GSPMD ``make_lifter_train_step`` on a 2 x 2 mesh with ``shard_params``
  (f32: loss rtol 1e-5; parameters and running statistics atol 1e-5 +
  rtol 1e-5, the JAX mesh suite's limits, or, element by element where
  the port's one-process f32 step is itself outside them, twice its
  distance from JAX) and against the port's one-process step in float64
  (1e-12; 1e-10 for the Linear biases that feed a BatchNorm, whose exact
  gradient is 0, and the running means they feed: ``PRE_BN``).
  Replicated tensors bitwise equal on all four ranks, each shard across
  its data peers.
- (iii) The same with ``grad_clip`` set where it binds.
- (iv) 1 x 2 with dropout 0.5 against one process in float64: the same
  masks, loss rtol 1e-12.
- (v) The checkpoint: a 2 x 2 save restores bit-equal and resumes
  bit-equal (JAX's ``tests/test_mesh_checkpoint.py``); the file holds the
  gathered tensors, which a one-process save of the restored state
  writes again bit for bit; it restores into 1 x 2.
- (vi) The DP SMPL-IK step on 2 ranks (ResNet-18, depth 8, 64 x 64, B =
  4, float64, dropout held, Adam at 2^-10) against the port's
  one-process step on the global batch and JAX's
  ``make_hybrik_train_step`` on a 2-device mesh in x64: loss and MPJPE
  sums rtol 1e-10, parameters atol 1e-8, running statistics 1e-10.
- (vii) ``dryrun_multichip(4, device="cpu")`` prints its seven lines,
  the second JAX's "temporal dp x sp".
"""

import concurrent.futures
import types

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import spawn
from torch_port_util import (flax_bn_lifter, flax_pose_smpl_net, flax_posenet, flax_posenet2d,
                             flax_temporal, flax_vit)

from pose3d_tpu_torch.data.synthetic import synthetic_h36m
from pose3d_tpu_torch.interop import weights as W
from pose3d_tpu_torch.parallel.sharding import infer_param_sharding, shard_params

torch.set_num_threads(2)

B = 16
F32_ATOL = F32_RTOL = 1e-5
F64_TOL = 1e-12
# The Linear biases that feed a train-mode BatchNorm, and that
# BatchNorm's running mean: BatchNorm subtracts the batch mean, so their
# exact gradient is 0 and each run's is rounding noise, which Adam's step
# -lr·g/(|g| + eps) turns into a move of lr·δg/eps (float64: δg ~1e-17,
# ~1e-12 a step; the running mean takes the move in). In float64 they are
# held to PRE_BN_F64 after three steps, every other tensor to F64_TOL.
PRE_BN = ("w1.bias", "linear_stages.0.w1.bias", "linear_stages.0.w2.bias",
          "batch_norm1.running_mean", "linear_stages.0.batch_norm1.running_mean",
          "linear_stages.0.batch_norm2.running_mean")
PRE_BN_F64 = 1e-10


# --- (i) the rule ----------------------------------------------------------------

def _flax_projection():
    import jax

    from pose3d_tpu.models.heads import ProjectionMLP

    model = ProjectionMLP()
    v = jax.jit(lambda k: model.init({"params": k}, np.zeros((1, 17, 3), np.float32),
                                     train=False))(jax.random.key(0))
    return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray, v["batch_stats"])


def _bridged(name):
    """(flax params, the bridge to a port state dict, the port's model)."""
    from pose3d_tpu_torch.models import heads, lifters, smpl_pose, temporal

    if name in ("martinez", "ae"):
        _, p, s = flax_bn_lifter(name)
        cls = lifters.MartinezLifter if name == "martinez" else lifters.AELifter
        bridge = W.martinez_lifter_from_flax if name == "martinez" else W.ae_lifter_from_flax
        return p, lambda q: bridge(q, s), cls(device="cpu")
    if name == "vit":
        _, p = flax_vit(n_blocks=1)
        return p, W.vit_lifter_from_flax, lifters.JointTransformerLifter(n_blocks=1, device="cpu")
    if name == "temporal":
        _, p = flax_temporal(clip_len=27, n_blocks=2)
        return p, W.temporal_lifter_from_flax, temporal.TemporalLifter(
            clip_len=27, n_blocks=2, device="cpu")
    if name == "projection":
        p, s = _flax_projection()
        return p, lambda q: W.projection_mlp_from_flax(q, s), heads.ProjectionMLP(device="cpu")
    fn, bridge, cls = {"posenet3d": (flax_posenet, W.posenet3d_from_flax, heads.PoseNet3D),
                       "posenet2d": (flax_posenet2d, W.posenet2d_from_flax, heads.PoseNet2D),
                       "pose_smpl_net": (flax_pose_smpl_net, W.pose_smpl_net_from_flax,
                                         smpl_pose.PoseSMPLNet)}[name]
    p, s = fn()
    kw = {"depth": 8} if name == "pose_smpl_net" else {}
    return p, lambda q: bridge(q, s), cls("resnet18", device="cpu", **kw)


def _jax_rule(params, bridge, names) -> dict:
    """JAX's rule at a model axis of 2, by bridged name (of the port's
    parameters ``names``): each parameter JAX shards is replaced by the
    index + 1 along its last axis, the rest by zeros, and bridged; the
    torch dim along which the marker runs is the sharded one."""
    import jax

    from pose3d_tpu.parallel.mesh import MODEL_AXIS, make_mesh
    from pose3d_tpu.parallel.sharding import infer_param_sharding as jax_rule

    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    specs = jax_rule(params, mesh)

    def marker(x, sharding):
        x = np.asarray(x)
        if MODEL_AXIS not in sharding.spec:
            return np.zeros_like(x)
        return np.broadcast_to(np.arange(1, x.shape[-1] + 1, dtype=x.dtype), x.shape).copy()

    out = {}
    for k, t in bridge(jax.tree.map(marker, params, specs)).items():
        if k not in names:
            continue
        a = t.numpy()
        if not a.any():
            out[k] = None
            continue
        dims = [d for d in range(a.ndim)
                if np.array_equal(np.moveaxis(a, d, -1),
                                  np.broadcast_to(np.arange(1, a.shape[d] + 1),
                                                  np.moveaxis(a, d, -1).shape))]
        assert len(dims) == 1, (k, dims)
        out[k] = dims[0]
    return out


MODEL_AXIS_2 = types.SimpleNamespace(shape=(1, 2), mesh_dim_names=("data", "model"))
BRIDGED = ("martinez", "ae", "vit", "temporal", "posenet3d", "posenet2d", "projection",
           "pose_smpl_net")


@pytest.mark.parametrize("name", BRIDGED)
def test_rule_shards_what_jax_shards(name):
    params, bridge, model = _bridged(name)
    got = infer_param_sharding(model, MODEL_AXIS_2)
    want = _jax_rule(params, bridge, set(got))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    assert got == want
    assert any(d is not None for d in got.values()), "the rule sharded nothing"
    if name == "martinez":
        assert got["w2.weight"] is None and got["w1.weight"] == 0
    if name in ("posenet3d", "posenet2d", "pose_smpl_net"):
        assert got["deconv_layers.0.weight"] == 1  # (in, out, kh, kw)


@pytest.mark.parametrize("name", ["vit", "temporal", "posenet3d", "projection"])
def test_shard_params_refuses_other_models(name):
    _, _, model = _bridged(name)
    layer = {"vit": "LayerNorm", "temporal": "LayerNorm", "posenet3d": "Conv2d",
             "projection": "Tanh"}[name]
    with pytest.raises(ValueError, match=f"{type(model).__name__} has a {layer}"):
        shard_params(model, MODEL_AXIS_2)


# --- (ii)-(vi) the steps and the checkpoint ---------------------------------------

def _batch():
    kp2d, kp3d = synthetic_h36m(B, seed=3)
    y1 = kp2d * np.arange(1, B + 1, dtype=np.float32).reshape(B, 1, 1)
    return y1.astype(np.float32), (kp3d - kp3d[:, :1]).astype(np.float32)


def _smpl_inputs():
    from test_torch_smpl_pose import _step_batch

    frames, cam, uvd, xyz = _step_batch(4)
    return (frames, *cam, uvd, xyz)


def _jax_martinez(params, stats, y1, y2, clip) -> dict:
    """JAX's GSPMD step on a 2 x 2 mesh with ``shard_params``, f32, three
    steps and plateau steps: losses and the bridged state dict."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.lifters import MartinezLifter
    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pose3d_tpu.parallel.sharding import shard_params as jax_shard
    from pose3d_tpu.train.state import create_train_state
    from pose3d_tpu.train.steps import make_lifter_train_step, plateau_step

    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    state = create_train_state(MartinezLifter(**cases.TP_FIELDS, dropout=0.0),
                               jax.random.key(0), jnp.zeros((B, 17, 2)), lr=cases.TP_LR,
                               optimizer="adam", grad_clip=clip)
    p = jax.tree.map(jnp.asarray, params)
    state = state.replace(params=p, batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=state.tx.init(p))
    state = jax.device_put(state, replicated(mesh))
    state = state.replace(params=jax_shard(state.params, mesh))
    x, y = (jax.device_put(jnp.asarray(a), batch_sharding(mesh)) for a in (y1, y2))
    step = make_lifter_train_step(loss="mse", donate=False)
    losses = []
    for i in range(cases.TP_STEPS):
        state, m = step(state, x, y, jax.random.key(i))
        state = plateau_step(state, m["loss"])
        losses.append(float(m["loss"]))
    sd = W.martinez_lifter_from_flax(jax.tree.map(np.asarray, state.params),
                                     jax.tree.map(np.asarray, state.batch_stats))
    return {"losses": losses, "full": {k: v.numpy() for k, v in sd.items()}}


def _jax_smpl(params, stats, arrays) -> dict:
    """JAX's ``make_hybrik_train_step`` on a 2-device mesh in x64, dropout
    intercepted, as ``test_torch_smpl_pose.py``'s float64 step runs it."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from test_torch_smpl_pose import _flax_net, _float64_outputs, _no_dropout

    from pose3d_tpu.models import smpl as js
    from pose3d_tpu.models import smpl_pose as jsp
    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.smpl_steps import make_hybrik_train_step as jax_step
    from pose3d_tpu.train.state import TrainState, make_optimizer

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        _float64_outputs(mp)
        mesh = make_mesh(n_data=2, devices=jax.devices()[:2])

        def f64(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        assembly = jsp.HybrIKPose(net=_flax_net(jnp.float64), smpl=js.synthetic_model(300, seed=1))
        tx = make_optimizer(cases.SMPL_LR, "adam")
        p64 = f64(params)
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=p64, batch_stats=f64(stats),
                           opt_state=tx.init(p64), plateau=plateau_init(cases.SMPL_LR), tx=tx,
                           apply_fn=None)
        state = jax.device_put(state, replicated(mesh))
        frames, *cam, uvd, xyz = (jax.device_put(jnp.asarray(a), batch_sharding(mesh))
                                  for a in arrays)
        with nn.intercept_methods(_no_dropout):
            state, m = jax_step(assembly, donate=False)(state, frames, tuple(cam), uvd, xyz,
                                                        jax.random.key(0))
        m = jax.tree.map(np.asarray, m)
        sd = W.pose_smpl_net_from_flax(jax.tree.map(np.asarray, state.params),
                                       jax.tree.map(np.asarray, state.batch_stats))
    return {"m": m, "sd": {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs, the port's one-process runs and JAX's, from one set
    of flax weights and one batch."""
    _, params, stats = flax_bn_lifter("martinez", **cases.TP_FIELDS, dropout=0.0)
    sd = {k: v.numpy() for k, v in W.martinez_lifter_from_flax(params, stats).items()}
    y1, y2 = _batch()
    sp, ss = flax_pose_smpl_net()
    smpl_params = {k: v.numpy() for k, v in W.pose_smpl_net_from_flax(sp, ss).items()}
    smpl_arrays = _smpl_inputs()
    log_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    # the 2 x 2 world runs while this process runs JAX; the two-rank world
    # restores the 2 x 2 world's file
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        four = pool.submit(spawn, cases.tp_four, 4, tmp_path_factory.mktemp("tp4"), sd, y1, y2,
                           log_dir)
        jax_runs = {clip: _jax_martinez(params, stats, y1, y2, clip)
                    for clip in (0.0, cases.TP_CLIP)}
        jax_runs["smpl"] = _jax_smpl(sp, ss, smpl_arrays)
        four = four.result()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(spawn, cases.tp_two, 2, tmp_path_factory.mktemp("tp2"), sd, y1, y2,
                          log_dir, (smpl_params, smpl_arrays))
        one = {(dtype, clip): cases.tp_run(cases.tp_state(sd, dtype, grad_clip=clip), y1, y2)
               for dtype in ("float32", "float64") for clip in (0.0, cases.TP_CLIP)}
        one["dropout"] = cases.tp_run(cases.tp_state(sd, "float64", dropout=0.5), y1, y2,
                                      seed=11)
        one["smpl"] = cases.smpl_dp(smpl_params, smpl_arrays)
        two = two.result()
    return {"four": four, "two": two, "one": one, "jax": jax_runs, "sd": sd, "log_dir": log_dir}


def _close(got: dict, want: dict, atol, rtol, what, pre_bn_atol=None):
    """Every tensor of ``want`` within the limits; the PRE_BN biases within
    ``pre_bn_atol`` where it is given."""
    assert set(got) == set(want), what
    for k, w in want.items():
        a = pre_bn_atol if pre_bn_atol is not None and k in PRE_BN else atol
        np.testing.assert_allclose(got[k], w, atol=a, rtol=rtol, err_msg=f"{what} {k}")


def _floats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if v.dtype.kind == "f"}


def _shards_agree(ranks, key):
    """Every rank's local state dict: replicated tensors bitwise equal on
    all ranks, shards across the data peers (the same model rank)."""
    spec = {k for k, v in ranks[0][key]["local"].items()
            if v.shape != ranks[0][key]["full"][k].shape}
    assert spec, "nothing was sharded"
    for r in ranks[1:]:
        peer = next(q for q in ranks if q["model_rank"] == r["model_rank"])
        for k, v in r[key]["local"].items():
            ref = (peer if k in spec else ranks[0])[key]["local"][k]
            assert v.tobytes() == ref.tobytes(), (r["data_rank"], r["model_rank"], k)
        for k, v in r[key]["full"].items():
            assert v.tobytes() == ranks[0][key]["full"][k].tobytes(), k
    return spec


def test_rule_reads_a_real_mesh(runs):
    """On every rank of the 2 x 2 ``DeviceMesh`` the rule reads a model
    axis of 2: its decisions are those on the stand-in mesh."""
    from pose3d_tpu_torch.models.lifters import MartinezLifter

    want = infer_param_sharding(MartinezLifter(**cases.TP_FIELDS, device="cpu"), MODEL_AXIS_2)
    assert any(d is not None for d in want.values())
    for r in runs["four"]:
        assert r["rule"] == want, (r["data_rank"], r["model_rank"])


@pytest.mark.parametrize("clip", [0.0, cases.TP_CLIP], ids=["plain", "clip"])
def test_dp_tp_step_matches_jax_in_f32(runs, clip):
    """Each tensor within the JAX mesh suite's f32 limits of JAX's, or,
    where the port's one-process f32 step is itself outside them, at most
    twice as far from JAX as it is: in f32 rounding noise moves the PRE_BN
    tensors by up to lr under Adam (and an element of a weight whose
    gradient nearly cancels by more than 1e-5) in both packages'
    one-device steps, so the sharded step is held to add nothing to it."""
    got, want = runs["four"][0][("float32", clip)], runs["jax"][clip]
    one = runs["one"][("float32", clip)]["full"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F32_RTOL)
    for k, w in _floats(want["full"]).items():
        if np.allclose(one[k], w, atol=F32_ATOL, rtol=F32_RTOL):
            np.testing.assert_allclose(got["full"][k], w, atol=F32_ATOL, rtol=F32_RTOL,
                                       err_msg=k)
        else:
            tp, own = (np.abs(a[k] - w).max() for a in (got["full"], one))
            assert tp <= 2 * own, (k, tp, own)
    spec = _shards_agree(runs["four"], ("float32", clip))
    assert "w2.weight" not in spec and "linear_stages.0.batch_norm2.running_var" in spec


@pytest.mark.parametrize("clip", [0.0, cases.TP_CLIP], ids=["plain", "clip"])
def test_dp_tp_step_is_the_one_process_step_in_f64(runs, clip):
    got, want = runs["four"][0][("float64", clip)], runs["one"][("float64", clip)]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F64_TOL)
    np.testing.assert_allclose(got["sums"], want["sums"], rtol=F64_TOL)
    _close(_floats(got["full"]), _floats(want["full"]), F64_TOL, 0, "2 x 2 vs one process",
           PRE_BN_F64)
    _shards_agree(runs["four"], ("float64", clip))
    # the eval step of the sharded model: the whole prediction on every rank
    assert all(r[("float64", clip)]["pred"].tobytes() == got["pred"].tobytes()
               for r in runs["four"])
    np.testing.assert_allclose(got["pred"], want["pred"], atol=PRE_BN_F64, rtol=0)


def test_the_clip_binds(runs):
    """With the clip the run differs from the run without: it bound."""
    a, b = (runs["one"][("float64", c)]["full"]["w2.weight"] for c in (0.0, cases.TP_CLIP))
    assert np.abs(a - b).max() > 1e-6


def test_dropout_masks_are_one_process_masks(runs):
    got, want = runs["two"][0]["dropout"], runs["one"]["dropout"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=F64_TOL)
    _close(_floats(got["full"]), _floats(want["full"]), F64_TOL, 0,
           "1 x 2 dropout vs one process", PRE_BN_F64)
    assert runs["two"][1]["dropout"]["losses"] == got["losses"]
    # the masks matter: without dropout the losses differ
    assert abs(got["losses"][0] - runs["one"][("float64", 0.0)]["losses"][0]) > 1e-3


def test_checkpoint_restores_and_resumes_bit_equal(runs):
    for r in runs["four"]:
        c = r["checkpoint"]
        assert c["meta"]["batch_size"] == B and c["step"] == (1, 1) and c["plateau"]
        assert c["restored_bitwise"] and c["resumed_bitwise"]
        assert c["moment_shapes"] == c["param_shapes"]
        assert any(s[0] == cases.TP_FIELDS["hidden"] // 2 for s in c["param_shapes"])


def test_checkpoint_file_is_a_one_process_file(runs, tmp_path):
    """The file holds the gathered tensors; restored into one process and
    saved again, it is the same file, tensor for tensor."""
    from pose3d_tpu_torch.train import checkpoint as ckpt

    log_dir = runs["log_dir"]
    payload = torch.load(f"{log_dir}/models/tp_run", weights_only=True)
    full = runs["four"][0]["checkpoint"]["full"]
    assert set(payload["model"]) == set(full)
    for k, v in payload["model"].items():
        assert v.numpy().tobytes() == full[k].tobytes(), k
    state, _ = ckpt.restore(cases.tp_state(runs["sd"], "float32"), log_dir, "tp_run")
    ckpt.save(state, tmp_path, "tp_run", batch_size=B)
    again = torch.load(tmp_path / "models" / "tp_run", weights_only=True)
    for part in ("model", "optimizer"):
        a, b = payload[part], again[part]
        flat_a, flat_b = _flat(a), _flat(b)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            if torch.is_tensor(flat_a[k]):
                assert flat_a[k].dtype == flat_b[k].dtype and flat_a[k].shape == flat_b[k].shape
                assert cases._same_bits(flat_a[k], flat_b[k]), (part, k)
            else:
                assert flat_a[k] == flat_b[k], (part, k)
    sd = ckpt.peek_params(log_dir, "tp_run")
    assert sd["w1.weight"].shape == (cases.TP_FIELDS["hidden"], 34)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def test_checkpoint_restores_into_1x2(runs):
    full = runs["four"][0]["checkpoint"]["full"]
    for r, res in enumerate(runs["two"]):
        got = res["restore"]
        assert got["step"] == 1 and got["moment_shapes"] == got["param_shapes"]
        for k, v in got["local"].items():
            if v.shape == full[k].shape:
                assert v.tobytes() == full[k].tobytes(), k
            else:
                w = v.shape[0]
                assert v.tobytes() == np.ascontiguousarray(full[k][r * w:(r + 1) * w]).tobytes(), k


@pytest.mark.parametrize("against", ["one_process", "jax"])
def test_dp_smpl_step(runs, against):
    got = runs["two"][0]["smpl"]
    assert all(r["smpl"]["sd"][k].tobytes() == v.tobytes()
               for r in runs["two"][1:] for k, v in got["sd"].items())
    want = runs["one"]["smpl"] if against == "one_process" else runs["jax"]["smpl"]
    for k in ("loss", "mpjpe_sums"):
        np.testing.assert_allclose(got["m"][k], want["m"][k], rtol=1e-10, err_msg=k)
    for name, w in want["sd"].items():
        if np.asarray(w).dtype.kind != "f":
            continue
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got["sd"][name], w, atol=atol, rtol=0, err_msg=name)


# --- (vii) the dry run ------------------------------------------------------------

def test_dryrun_multichip_prints_its_seven_lines(capsys):
    from pose3d_tpu_torch.parallel.dryrun import dryrun_multichip

    lines, launches = dryrun_multichip(4, device="cpu")
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines and len(lines) == 7
    assert all(line.startswith("dryrun_multichip ok: ") for line in lines)
    assert "mesh={'data': 2, 'model': 2}" in lines[0] and "(dp x tp)" in lines[0]
    assert "temporal dp x sp" in lines[1] and "smpl-ik dp" in lines[3]
    for line in lines:
        assert np.isfinite(float(line.rsplit("loss=", 1)[1].split()[0])), line
    assert not any(launches.values())  # the CPU runs the kernels' plain versions
