"""The port's SMPL body model, HybrIK inverse kinematics and affine crop
geometry (``pose3d_tpu_torch/models/{smpl,hybrik}.py``,
``core/affine.py``) against the JAX package, on the CPU.

Bodies: ``synthetic_model(300, seed=1)`` and the 6890-vertex synthetic body
with the reference's leaf vertex ids (411, 2445, 5905, 3216, 6617), as
``tests/test_reference_parity_lbs.py`` builds it. Skeletons come from
forward kinematics (random axis-angle poses and betas, seeded with numpy)
plus a little noise, as ``tests/test_smpl_hybrik.py`` builds them; the
same numpy inputs go to both packages.

Tolerances:

- the tables and ``synthetic_model``'s arrays: equal; ``load_smpl`` on a
  fabricated pickle in the reference's schema: bitwise;
- the JAX side runs in float64 (``enable_x64``) on the inputs' values;
  the port in float64: atol 1e-10 (the same expressions, sums in other
  orders; measured ~1e-14); the port in f32, on the same f32 inputs:
  atol 1e-5 on positions in metres and on rotations (measured up to
  3.9e-6 on rotations, 6.2e-7 on positions). JAX's own f32 run is no
  yardstick here: on the full body's eval path its rotations lie 1.1e-5
  from its float64 ones;
- the gradients of both IK paths against ``jax.grad`` in float64: atol
  1e-10 + rtol 1e-9;
- the eval path's 15 mm clamp fires on some joints and not on others, and
  no joint's distance lies within 1e-5 of the threshold (the result is
  the same with the threshold moved by 1e-5 either way);
- ``core/affine.py``: bitwise where both sides are numpy (and cv2);
  ``rot_aa`` within 1e-6 (its rotation comes from each package's
  ``batch_rodrigues`` in f32).
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from pose3d_tpu_torch.core import affine as taff
from pose3d_tpu_torch.models import hybrik as th
from pose3d_tpu_torch.models import smpl as ts

torch.set_num_threads(2)

REF_LEAVES = (411, 2445, 5905, 3216, 6617)
BODIES = {"small": (300, 1, None), "full": (6890, 0, REF_LEAVES)}
# the port's dtype -> (numpy dtype, torch dtype, atol against JAX's float64)
DTYPES = {"f32": (np.float32, torch.float32, 1e-5),
          "f64": (np.float64, torch.float64, 1e-10)}
B = 3


def _bodies(name):
    """(the JAX package's SMPLModel, the port's) for ``name``."""
    from pose3d_tpu.models import smpl as js

    n, seed, leaves = BODIES[name]
    jm, tm = js.synthetic_model(n, seed=seed), ts.synthetic_model(n, seed=seed)
    if leaves:
        jm = dataclasses.replace(jm, leaf_vertex_ids=leaves)
        tm = dataclasses.replace(tm, leaf_vertex_ids=leaves)
    return jm, tm


def _rest29(model, betas):
    """(B, 29, 3) rest joints (24 regressed, 5 leaf vertices), float64."""
    v_shaped = model.v_template + np.einsum("bl,vkl->bvk", betas, model.shapedirs)
    rest24 = np.einsum("jv,bvk->bjk", model.j_regressor, v_shaped)
    return np.concatenate([rest24, v_shaped[:, list(model.leaf_vertex_ids)]], 1)


def _skeleton(model, seed, twist=True, noise=0.005, scale=0.25):
    """(betas, rest29, skeleton (B, 29, 3), phis (B, 23, 2)) as float64
    numpy: FK of random local rotations (the leaves unrotated) plus
    ``noise`` metres of N(0, 1) noise; phis random (unnormalised) with
    ``twist``, else (1, 0)."""
    rng = np.random.default_rng(seed)
    betas = rng.normal(scale=0.3, size=(B, 10))
    rest29 = _rest29(model, betas)
    rots = ts.batch_rodrigues(torch.from_numpy(scale * rng.standard_normal((B, 24, 3))))
    rots = torch.cat([rots, torch.eye(3, dtype=rots.dtype).expand(B, 5, 3, 3)], 1)
    pos, _ = ts.batch_rigid_transform(rots, torch.from_numpy(rest29), parents=ts.PARENTS,
                                      levels=ts.IK_LEVELS[1:])
    pos = pos.numpy() + noise * rng.standard_normal(pos.shape)
    if twist:
        phis = rng.standard_normal((B, 23, 2))
    else:
        phis = np.concatenate([np.ones((B, 23, 1)), np.zeros((B, 23, 1))], -1)
    return betas, rest29, pos, phis


def _jax(fn, args, **kwargs):
    """fn(*args) in the JAX package in float64 on the args' values, numpy
    in and out."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        out = fn(*[jnp.asarray(np.asarray(a, np.float64)) for a in args], **kwargs)
        return jax.tree.map(np.asarray, out)


def _port(fn, args, tdtype, **kwargs):
    out = fn(*[torch.from_numpy(np.asarray(a)).to(tdtype) for a in args], **kwargs)
    return [o.numpy() for o in out] if isinstance(out, (tuple, list)) else out.numpy()


def _close(got, want, atol, what=""):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{what} output {i}")


# --- the tables and the bodies -------------------------------------------------

def test_tables_match_jax():
    from pose3d_tpu.models import hybrik as jh
    from pose3d_tpu.models import smpl as js

    np.testing.assert_array_equal(ts.PARENTS, js.PARENTS)
    np.testing.assert_array_equal(ts.CHILDREN, js.CHILDREN)
    np.testing.assert_array_equal(ts.children_map(), js.children_map())
    assert ts.CHILDREN[0] == 3 and ts.CHILDREN[9] == 12
    assert ts.LEAF_VERTEX_IDS == js.LEAF_VERTEX_IDS == REF_LEAVES
    assert ts.IK_LEVELS == js.IK_LEVELS and ts.FK_LEVELS == js.FK_LEVELS
    assert th._pelvis_children() == jh._pelvis_children() == [3, 1, 2]


@pytest.mark.parametrize("n,seed", [(300, 1), (400, 0), (6890, 0)])
def test_synthetic_model_draws_the_jax_arrays(n, seed):
    from pose3d_tpu.models import smpl as js

    want, got = js.synthetic_model(n, seed=seed), ts.synthetic_model(n, seed=seed)
    for name in ts.ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == np.float32
    assert got.leaf_vertex_ids == want.leaf_vertex_ids and got.num_vertices == n


def _fake_pickle(tmp_path):
    """A pickle in the reference's schema from the synthetic body
    (``tests/test_asset_seams.py``): (V, 3, 207) float64 posedirs, a
    scipy-sparse J_regressor, the extra keys a real one carries."""
    import scipy.sparse

    m = ts.synthetic_model(n_vertices=120, seed=3)
    v = m.num_vertices
    data = {
        "v_template": m.v_template.astype(np.float64),
        "shapedirs": m.shapedirs.astype(np.float64),
        "posedirs": np.ascontiguousarray(m.posedirs.T.reshape(v, 3, 207)).astype(np.float64),
        "J_regressor": scipy.sparse.csc_matrix(m.j_regressor),
        "weights": m.lbs_weights.astype(np.float64),
        "kintree_table": np.stack([np.concatenate([[0], m.parents[1:24]]), np.arange(24)]),
        "f": np.zeros((4, 3), np.int64),
        "J": np.zeros((24, 3)),
        "bs_style": "lbs",
    }
    pkl = tmp_path / "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump(data, fh)
    h36m = tmp_path / "J_regressor_h36m.npy"
    np.save(h36m, m.j_regressor_h36m.astype(np.float64))
    return pkl, h36m, m


def test_load_smpl_reads_a_reference_pickle_as_jax_does(tmp_path):
    from pose3d_tpu.models import smpl as js

    pkl, h36m, m = _fake_pickle(tmp_path)
    got, want = ts.load_smpl(pkl, h36m), js.load_smpl(pkl, h36m)
    for name in ts.ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        np.testing.assert_allclose(getattr(got, name), getattr(m, name), atol=1e-6, rtol=0)
        assert getattr(got, name).dtype == np.float32
    assert got.posedirs.shape == (207, 120 * 3)
    rng = np.random.default_rng(4)
    betas = rng.normal(size=(2, 10)).astype(np.float32)
    pose = (0.3 * rng.standard_normal((2, 72))).astype(np.float32)
    _close(_port(lambda b, p: ts.lbs(got, b, p), (betas, pose), torch.float32),
           _jax(lambda b, p: js.lbs(want, b, p), (betas, pose)), 1e-5, "lbs")


# --- the math, f32 and float64 ------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rotations_match_jax(dtype):
    """batch_rodrigues (a zero vector too), _skew, quat_to_rotmat on
    unnormalised quaternions, rotmat_to_quat on random rotations and on
    ties between its four cases (the identity, half turns, w = x)."""
    from pose3d_tpu.models import smpl as js

    ndt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    aa = rng.standard_normal((16, 3)).astype(ndt)
    aa[0] = 0.0
    _close(_port(ts.batch_rodrigues, (aa,), tdt), _jax(js.batch_rodrigues, (aa,)), atol,
           "rodrigues")
    _close(_port(ts._skew, (aa,), tdt), _jax(js._skew, (aa,)), 0.0, "skew")
    quats = (3.0 * rng.standard_normal((16, 4))).astype(ndt)
    _close(_port(ts.quat_to_rotmat, (quats,), tdt), _jax(js.quat_to_rotmat, (quats,)),
           atol, "quat_to_rotmat")
    rots = _port(ts.batch_rodrigues, (aa,), tdt)
    ties = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                     np.diag([-1.0, -1.0, 1.0]),
                     np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])]).astype(ndt)  # w = x
    for what, r in (("random", rots), ("ties", ties)):
        got = _port(ts.rotmat_to_quat, (r,), tdt)
        _close(got, _jax(js.rotmat_to_quat, (r,)), atol, f"rotmat_to_quat {what}")
    np.testing.assert_allclose(_port(ts.quat_to_rotmat, (got,), tdt), ties, atol=atol * 10)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bones_match_jax(dtype):
    from pose3d_tpu.models import smpl as js

    ndt, tdt, atol = DTYPES[dtype]
    _, tm = _bodies("small")
    joints = _skeleton(tm, 6)[2][:, :24].astype(ndt)
    got = _port(ts.joints2bones, (joints,), tdt)
    _close(got, _jax(js.joints2bones, (joints,)), atol, "joints2bones")
    _close(_port(ts.bones2joints, got, tdt), _jax(js.bones2joints, got), atol,
           "bones2joints")
    np.testing.assert_allclose(_port(ts.bones2joints, got, tdt), joints, atol=atol * 10)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("body", sorted(BODIES))
def test_lbs_matches_jax(body, dtype):
    """vertices, joints, rotations and the Human3.6M joints, from axis-angle
    poses and (pose2rot=False) from rotation matrices."""
    from pose3d_tpu.models import smpl as js

    ndt, tdt, atol = DTYPES[dtype]
    jm, tm = _bodies(body)
    rng = np.random.default_rng(7)
    betas = rng.normal(scale=0.5, size=(B, 10)).astype(ndt)
    pose = (0.4 * rng.standard_normal((B, 72))).astype(ndt)
    got = _port(lambda b, p: ts.lbs(tm, b, p), (betas, pose), tdt)
    _close(got, _jax(lambda b, p: js.lbs(jm, b, p), (betas, pose)), atol, "lbs")
    assert got[0].shape == (B, tm.num_vertices, 3) and got[3].shape == (B, 17, 3)
    rots = got[2].astype(ndt)
    _close(_port(lambda b, r: ts.lbs(tm, b, r, pose2rot=False), (betas, rots), tdt),
           _jax(lambda b, r: js.lbs(jm, b, r, pose2rot=False), (betas, rots)), atol,
           "lbs pose2rot=False")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_rigid_transform_matches_jax(dtype):
    """FK over the 24 joints (FK_LEVELS) and over the extended 29-joint tree
    (IK_LEVELS[1:])."""
    from pose3d_tpu.models import smpl as js

    ndt, tdt, atol = DTYPES[dtype]
    _, tm = _bodies("small")
    rng = np.random.default_rng(8)
    rest29 = _rest29(tm, rng.normal(scale=0.3, size=(B, 10))).astype(ndt)
    rots = _port(ts.batch_rodrigues, ((0.5 * rng.standard_normal((B, 29, 3))).astype(ndt),),
                 tdt)
    _close(_port(ts.batch_rigid_transform, (rots[:, :24], rest29[:, :24]), tdt),
           _jax(js.batch_rigid_transform, (rots[:, :24], rest29[:, :24])), atol, "fk24")
    kw = {"parents": ts.PARENTS, "levels": ts.IK_LEVELS[1:]}
    _close(_port(ts.batch_rigid_transform, (rots, rest29), tdt, **kw),
           _jax(js.batch_rigid_transform, (rots, rest29), **kw), atol, "fk29")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_orientations_match_jax(dtype):
    """rotmat_between, the SVD and naive pelvis orientations, the
    three-children SVD (unused by the IK, in JAX too) and Kabsch's
    all-zero case (the identity)."""
    from pose3d_tpu.models import hybrik as jh

    ndt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((2, 8, 3)).astype(ndt)
    _close(_port(th.rotmat_between, (a, b), tdt), _jax(jh.rotmat_between, (a, b)), atol,
           "rotmat_between")
    _, tm = _bodies("small")
    _, rest29, pos, _ = _skeleton(tm, 10)
    rel_rest = (rest29 - np.where(ts.PARENTS[None, :, None] >= 0,
                                  rest29[:, ts.PARENTS.clip(0)], 0.0)).astype(ndt)
    rel_pose = (pos - np.where(ts.PARENTS[None, :, None] >= 0,
                               pos[:, ts.PARENTS.clip(0)], 0.0)).astype(ndt)
    for name in ("pelvis_orient_svd", "pelvis_orient_naive"):
        _close(_port(getattr(th, name), (rel_pose, rel_rest), tdt),
               _jax(getattr(jh, name), (rel_pose, rel_rest)), atol, name)
    chain = _port(ts.batch_rodrigues, (rng.standard_normal((B, 3)).astype(ndt),), tdt)
    kids = [rel_pose[:, c] for c in (12, 13, 14)]
    rests = [rel_rest[:, c] for c in (12, 13, 14)]
    got = th.three_children_orient_svd([torch.from_numpy(k).to(tdt) for k in kids],
                                       [torch.from_numpy(r).to(tdt) for r in rests],
                                       torch.from_numpy(chain).to(tdt)).numpy()
    _close(got, _jax(lambda c, *kr: jh.three_children_orient_svd(list(kr[:3]), list(kr[3:]), c),
                     (chain, *kids, *rests)), atol, "three_children_orient_svd")
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape),
                               atol=atol * 10)
    zero = np.zeros((2, 3, 3), ndt)
    np.testing.assert_array_equal(_port(th._kabsch, (zero, zero), tdt),
                                  np.broadcast_to(np.eye(3), (2, 3, 3)))


@pytest.mark.parametrize("twist", [True, False], ids=["twist", "no_twist"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "naive"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("body", sorted(BODIES))
def test_inverse_kinematics_matches_jax(body, dtype, train, twist):
    """The local rotations and the rotated rest pose, on FK skeletons with
    5 mm of noise, both IK paths, with and without twist."""
    from pose3d_tpu.models import hybrik as jh

    ndt, tdt, atol = DTYPES[dtype]
    _, tm = _bodies(body)
    _, rest29, pos, phis = _skeleton(tm, 11, twist=twist)
    args = tuple(a.astype(ndt) for a in (pos, phis, rest29))
    got = _port(th.inverse_kinematics, args, tdt, train=train)
    _close(got, _jax(jh.inverse_kinematics, args, train=train), atol, "ik")
    assert got[0].shape == (B, 24, 3, 3) and got[1].shape == (B, 29, 3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ik_global_orient_and_leaf_thetas_match_jax(dtype):
    from pose3d_tpu.models import hybrik as jh

    ndt, tdt, atol = DTYPES[dtype]
    _, tm = _bodies("small")
    _, rest29, pos, phis = _skeleton(tm, 12)
    rng = np.random.default_rng(13)
    orient, leaves = (_port(ts.batch_rodrigues, (rng.standard_normal(s).astype(ndt),), tdt)
                      for s in ((B, 3), (B, 5, 3)))
    args = tuple(a.astype(ndt) for a in (pos, phis, rest29))
    for train in (False, True):
        got = th.inverse_kinematics(*(torch.from_numpy(a).to(tdt) for a in args), train=train,
                                    global_orient=torch.from_numpy(orient),
                                    leaf_thetas=torch.from_numpy(leaves))
        want = _jax(lambda *a: jh.inverse_kinematics(*a[:3], train=train, global_orient=a[3],
                                                     leaf_thetas=a[4]),
                    (*args, orient, leaves))
        _close([g.numpy() for g in got], want, atol, f"ik options train={train}")
        np.testing.assert_allclose(got[0][:, 0].numpy(), orient, atol=0)


def _clamped_ik(monkeypatch, threshold, args):
    monkeypatch.setattr(th, "CLAMP_M", threshold)
    return th.inverse_kinematics(*args, train=False)[0]


@pytest.mark.parametrize("body", sorted(BODIES))
def test_eval_clamp_fires_on_some_joints_and_matches_jax(body, monkeypatch):
    """A mid-chain joint moved 10 cm (``test_smpl_hybrik.py``'s outlier),
    float64: the result differs both from never clamping and from always
    clamping, is the same with the threshold 1e-5 higher or lower (no
    distance near it, so no flipped branch decides the comparison), and
    equals JAX's."""
    from pose3d_tpu.models import hybrik as jh

    _, tm = _bodies(body)
    _, rest29, pos, phis = _skeleton(tm, 14, twist=False, noise=0.0, scale=0.1)
    pos[:, 4] += [0.1, 0.0, 0.0]
    args = [torch.from_numpy(a) for a in (pos, phis, rest29)]
    default = th.inverse_kinematics(*args, train=False)[0]
    never, always = (_clamped_ik(monkeypatch, t, args) for t in (np.inf, -1.0))
    assert (default - never).abs().amax() > 1e-3 and (default - always).abs().amax() > 1e-3
    for t in (0.015 - 1e-5, 0.015 + 1e-5):
        assert torch.equal(_clamped_ik(monkeypatch, t, args), default), t
    monkeypatch.setattr(th, "CLAMP_M", 15.0 / 1000.0)
    want = _jax(jh.inverse_kinematics, (pos, phis, rest29), train=False)[0]
    np.testing.assert_allclose(default.numpy(), want, atol=1e-10, rtol=0)


def test_degenerate_skeleton_matches_jax():
    """An all-zero skeleton: finite rotations on both paths, as JAX's
    (epsilons in every normalisation, the identity for an all-zero S)."""
    from pose3d_tpu.models import hybrik as jh

    _, tm = _bodies("small")
    _, rest29, pos, phis = _skeleton(tm, 15, twist=False)
    zero = np.zeros_like(pos)
    for train in (False, True):
        got = th.inverse_kinematics(*(torch.from_numpy(a) for a in (zero, phis, rest29)),
                                    train=train)[0].numpy()
        want = _jax(jh.inverse_kinematics, (zero, phis, rest29), train=train)[0]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-10, rtol=0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "naive"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("body", sorted(BODIES))
def test_hybrik_matches_jax(body, dtype, train):
    """The whole pass and the root-centring: vertices, joints, rotations,
    Human3.6M joints."""
    from pose3d_tpu.models import hybrik as jh

    ndt, tdt, atol = DTYPES[dtype]
    jm, tm = _bodies(body)
    betas, _, pos, phis = _skeleton(tm, 16)
    args = tuple(a.astype(ndt) for a in (betas, pos, phis))

    def jax_fn(*a):
        v, j, r, h = jh.hybrik(jm, *a, train=train)
        return (*jh.root_centre_outputs(v, j, h), r)

    def port_fn(*a):
        v, j, r, h = th.hybrik(tm, *a, train=train)
        return (*th.root_centre_outputs(v, j, h), r)

    got = _port(port_fn, args, tdt)
    _close(got, _jax(jax_fn, args), atol, "hybrik")
    np.testing.assert_allclose(got[1][:, 0], 0.0, atol=atol)
    np.testing.assert_allclose(got[2][:, 0], 0.0, atol=atol)


@pytest.mark.parametrize("train", [True, False], ids=["naive", "eval"])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_gradients_match_jax_grad(body, train):
    """d/d(betas, skeleton, phis) of the mean square of the Human3.6M joints
    and the vertices, float64: through the naive path (the train step's)
    and the eval path. The skeleton enters the naive path only detached
    (lbs.py:597), so its gradient there is 0 on both sides."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models import hybrik as jh

    jm, tm = _bodies(body)
    betas, _, pos, phis = _skeleton(tm, 17)

    def jax_loss(b, s, p):
        v, _, _, h = jh.hybrik(jm, b, s, p, train=train)
        return jnp.mean(jnp.square(h)) + jnp.mean(jnp.square(v))

    with jax.enable_x64(True):
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (betas, pos, phis)))
        want = [np.asarray(w) for w in want]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (betas, pos, phis)]
    v, _, _, h = th.hybrik(tm, *args, train=train)
    (h.square().mean() + v.square().mean()).backward()
    for name, a, w in zip(("betas", "skeleton", "phis"), args, want):
        assert (np.abs(w).max() > 0) == (train is False or name != "skeleton"), name
        got = np.zeros_like(w) if a.grad is None else a.grad.numpy()  # None: no path
        np.testing.assert_allclose(got, w, atol=1e-10, rtol=1e-9, err_msg=name)


def test_smpl_tensors_hold_the_body_in_f32():
    """``SMPLTensors``: non-persistent buffers (no state-dict keys) that a
    bf16 cast leaves f32 and a float64 cast widens; ``lbs`` and ``hybrik``
    on it equal the same functions on the numpy body, bitwise."""
    _, tm = _bodies("small")
    body = ts.SMPLTensors(tm, device="cpu")
    assert body.state_dict() == {} and body.num_vertices == 300
    np.testing.assert_array_equal(body.child_ids, tm.children)
    body.to(torch.bfloat16)
    assert all(getattr(body, n).dtype == torch.float32 for n in ts.ARRAYS)
    betas, _, pos, phis = (torch.from_numpy(a.astype(np.float32)) for a in _skeleton(tm, 18))
    pose = 0.3 * torch.randn(B, 72, generator=torch.Generator().manual_seed(0))
    for got, want in ((ts.lbs(body, betas, pose), ts.lbs(tm, betas, pose)),
                      (th.hybrik(body, betas, pos, phis), th.hybrik(tm, betas, pos, phis))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    body.double()
    assert all(getattr(body, n).dtype == torch.float64 for n in ts.ARRAYS)


# --- core/affine.py -------------------------------------------------------------

def _affine_cases(rng):
    """(function name, args, kwargs) of the numpy functions, on
    ``tests/test_affine.py``'s cases and random ones."""
    center, scale = rng.uniform(100, 900, 2), rng.uniform(100, 400, 2)
    pts = rng.uniform(0, 1000, (10, 2))
    uvd = rng.uniform(-0.5, 0.5, (2, 17, 3))
    return [
        ("get_affine_transform", ([128, 128], 256, 0, (256, 256)), {}),
        ("get_affine_transform", (center, scale, 30.0, (256, 192)), {}),
        ("get_affine_transform", (center, scale, -15.0, (256, 192)), {"inv": True}),
        ("get_affine_transform", (center, 300.0, 12.0, (64, 64)), {"shift": (0.1, -0.2)}),
        ("affine_transform", (pts, np.float32(rng.standard_normal((2, 3)))), {}),
        ("bbox_to_center_scale", ((0, 0, 100, 50),), {"aspect_ratio": 1.0, "scale_mult": 1.0}),
        ("bbox_to_center_scale", ((10, 20, 40, 220),), {"aspect_ratio": 0.75}),
        ("box_crop_affine", ((12, 30, 200, 180), (64, 48)), {}),
        ("box_crop_affine", ((0, 0, 100, 300), (256, 256)), {"inv": True}),
        ("box_crop_affine", ((5, 7, 50, 20), (32, 96)), {}),
        ("fix_box", ((50, 10, 70, 90), (64, 64)), {}),
        ("fix_box", ((10, 50, 90, 70), (64, 64)), {}),
        ("fix_box", ((0, 0, 64, 64), (64, 64)), {}),
        ("transform_preds", (pts, center, scale, (64, 64)), {}),
        ("heatmap_uvd_to_image_coords", (uvd, (100, 200, 356, 456)), {}),
        ("heatmap_uvd_to_image_coords", (uvd, (10, 20, 110, 260)),
         {"mean_bbox_scale": 180.0}),
        ("rotate_points_2d", (np.array([[1.0, 0.0, 5.0]]), 90.0), {}),
        ("rotate_points_2d", (rng.standard_normal((5, 17, 3)), -33.0), {}),
        ("_rotate_2d", ([0.0, -50.0], 0.3), {}),
        ("_third_point", (np.array([1.0, 2.0]), np.array([-3.0, 5.0])), {}),
    ]


def test_affine_numpy_functions_equal_jax_bitwise():
    from pose3d_tpu.core import affine as jaff

    cases = _affine_cases(np.random.default_rng(20))
    for name, args, kwargs in cases:
        got, want = getattr(taff, name)(*args, **kwargs), getattr(jaff, name)(*args, **kwargs)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
            assert np.asarray(got).dtype == np.asarray(want).dtype, name


def test_dpg_jitter_equals_jax_for_one_generator_seed():
    from pose3d_tpu.core import affine as jaff

    got_rng, want_rng = np.random.default_rng(21), np.random.default_rng(21)
    for bbox in [(50, 60, 300, 400), (10, 10, 90, 30), (0, 0, 999, 999)] * 20:
        got = taff.dpg_jitter(bbox, 1000, 1000, got_rng)
        np.testing.assert_array_equal(got, jaff.dpg_jitter(bbox, 1000, 1000, want_rng))
        assert got[0] < got[2] and got[1] < got[3]


def test_affine_crops_equal_jax_bitwise():
    """The cv2 warps: crop_image, crop_box, crop_box_rot, fix_crop_box,
    fix_crop_box_rot, crop_box_inverse, on one seeded image."""
    from pose3d_tpu.core import affine as jaff

    img = np.random.default_rng(22).random((120, 160, 3)).astype(np.float32)
    bbox = (40, 30, 104, 94)
    cases = [
        ("crop_image", (img, [80.0, 60.0], 90.0, 25.0, (64, 48))),
        ("crop_box", (img, bbox, (64, 64))),
        ("crop_box_rot", (img, bbox, (64, 48), 20.0)),
        ("fix_crop_box", (img, (50, 10, 70, 90), (64, 64))),
        ("fix_crop_box_rot", (img, (50, 10, 70, 90), (64, 64), -10.0)),
        ("crop_box_inverse", (img[:64, :64], bbox, (120, 160), (64, 64))),
    ]
    for name, args in cases:
        got, want = getattr(taff, name)(*args), getattr(jaff, name)(*args)
        if name.startswith("fix_"):
            assert got[1] == want[1], name
            got, want = got[0], want[0]
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(img, np.random.default_rng(22).random((120, 160, 3))
                                  .astype(np.float32))  # not modified in place


def test_rot_aa_matches_jax():
    from pose3d_tpu.core import affine as jaff

    rng = np.random.default_rng(23)
    for deg in (30.0, -75.0, 0.0, 180.0):
        aa = rng.normal(scale=0.5, size=3)
        np.testing.assert_allclose(taff.rot_aa(aa, deg), jaff.rot_aa(aa, deg), atol=1e-6, rtol=0)
    aa = rng.normal(scale=0.5, size=3)
    np.testing.assert_allclose(taff.rot_aa(taff.rot_aa(aa, 30.0), -30.0), aa, atol=1e-4)
    np.testing.assert_array_equal(taff.rot_aa(np.zeros(3), 0.0), np.zeros(3))
