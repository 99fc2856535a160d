"""The port's pose-space core (``pose3d_tpu_torch/core/``: ``quaternion.py``,
``transforms.py``, ``skeleton.py``, ``cameras.py``) against the JAX
package's, on the CPU, on seeded numpy inputs.

Tolerances: the quaternion functions, ``world_to_camera``,
``zero_centre``, ``camera_projection`` and ``coco_to_h36m`` (f32) atol
1e-6: the same expressions, which XLA may fuse into other roundings;
every flip bitwise (a negation and a gather); every copied table equal to
its original, dtype included.
"""

import numpy as np
import pytest
import torch

from pose3d_tpu_torch.core import cameras, quaternion, skeleton, transforms

torch.set_num_threads(2)

PAIRS = ((1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))
TWIST_PAIRS = ((1, 2), (4, 5), (13, 14), (16, 17), (18, 19), (20, 21), (22, 23))


def _quats(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(name, rng):
    """Seeded f32 arguments of the function ``name``."""
    if name == "q_conjugate":
        return (_quats(rng, (5, 3)),)
    if name == "q_mult":
        return _quats(rng, (5, 3)), _quats(rng, (5, 3))
    if name == "qv_mult":
        return _quats(rng, (5, 1)), rng.standard_normal((5, 17, 3)).astype(np.float32)
    if name == "quat_to_rotmat":
        return (_quats(rng, (7,)),)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["q_conjugate", "q_mult", "qv_mult", "quat_to_rotmat"])
def test_quaternion_matches_jax(name):
    from pose3d_tpu.core import quaternion as jq

    args = _inputs(name, np.random.default_rng(0))
    want = np.asarray(getattr(jq, name)(*args))
    got = getattr(quaternion, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_qv_mult_rotates_as_the_matrix():
    rng = np.random.default_rng(1)
    q, v = torch.from_numpy(_quats(rng, (6,))), torch.from_numpy(
        rng.standard_normal((6, 3)).astype(np.float32))
    want = (quaternion.quat_to_rotmat(q) @ v[..., None])[..., 0]
    torch.testing.assert_close(quaternion.qv_mult(q, v), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dim", [2, 3])
def test_flip_pose_equals_jax_bitwise(dim):
    from pose3d_tpu.core.transforms import flip_pose as jax_flip

    pose = np.random.default_rng(2).random((4, 6, 17, dim)).astype(np.float32)
    want = np.asarray(jax_flip(pose))
    got = transforms.flip_pose(torch.from_numpy(pose)).numpy()
    np.testing.assert_array_equal(got, want)
    # a flip undone by a flip
    twice = transforms.flip_pose(transforms.flip_pose(torch.from_numpy(pose)))
    if dim == 3:
        assert torch.equal(twice, torch.from_numpy(pose))


def test_flip_pose_refuses_other_widths():
    with pytest.raises(ValueError, match="last dim"):
        transforms.flip_pose(torch.zeros(2, 17, 4))


def _transform_args(name, rng):
    if name == "world_to_camera":
        return (rng.standard_normal((8, 17, 3)).astype(np.float32),
                _quats(rng, (8, 1)),
                (rng.standard_normal((8, 1, 3)) * 2000).astype(np.float32))
    if name == "zero_centre":
        return (rng.standard_normal((8, 17, 3)).astype(np.float32),)
    if name == "camera_projection":
        pts = rng.standard_normal((8, 17, 3)).astype(np.float32)
        pts[..., 2] = np.abs(pts[..., 2]) + 2.0
        pts[0, 0, 2] = 0.0  # the clamp at 1e-6
        return (pts, (1100 + 50 * rng.random((8, 1, 2))).astype(np.float32),
                (500 + 20 * rng.random((8, 1, 2))).astype(np.float32))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["world_to_camera", "zero_centre", "camera_projection"])
def test_transform_matches_jax(name):
    from pose3d_tpu.core import transforms as jt

    args = _transform_args(name, np.random.default_rng(3))
    want = np.asarray(getattr(jt, name)(*args))
    got = getattr(transforms, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape
    if name == "camera_projection":  # pixels of ~1e3, and 1e9 at the clamp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,shape,pairs,kw", [
    ("flip_heatmap", (2, 17, 5, 6), PAIRS, {"shift": False}),
    ("flip_heatmap", (2, 17, 5, 6), PAIRS, {"shift": True}),
    ("flip_xyz_joints", (3, 17, 3), PAIRS, {}),
    ("flip_thetas", (3, 24, 3), TWIST_PAIRS, {}),
    ("flip_twist", (3, 23, 2), TWIST_PAIRS, {}),
])
def test_flips_equal_jax_bitwise(name, shape, pairs, kw):
    from pose3d_tpu.core import transforms as jt

    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(getattr(jt, name)(x, pairs, **kw))
    got = getattr(transforms, name)(torch.from_numpy(x), pairs, **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_coco_to_h36m_matches_jax(kind):
    from pose3d_tpu.core.skeleton import coco_to_h36m as jax_remap

    coco = np.random.default_rng(5).random((6, 17, 2)).astype(np.float32)
    want = np.asarray(jax_remap(coco))
    if kind == "numpy":
        got = skeleton.coco_to_h36m(coco)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
    else:
        got = skeleton.coco_to_h36m(torch.from_numpy(coco)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the synthesised joints: root and neck midpoints, belly between them
    np.testing.assert_allclose(got[:, 0], (coco[:, 11] + coco[:, 12]) / 2, atol=1e-6)
    np.testing.assert_allclose(got[:, 7], (got[:, 0] + got[:, 8]) / 2, atol=1e-6)


@pytest.mark.parametrize("name", ["H36M_KEYPOINTS_FROM_32", "JOINT_NAMES", "BONES",
                                  "LEFT_JOINTS", "RIGHT_JOINTS", "FLIP_PERMUTATION",
                                  "COCO_TO_H36M_MATRIX"])
def test_skeleton_tables_equal_the_originals(name):
    from pose3d_tpu.core import skeleton as js

    want, got = getattr(js, name), getattr(skeleton, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("name", ["SUBJECT_INDEX", "SUBJECTS", "ORIENTATION", "TRANSLATION"])
def test_camera_extrinsics_equal_the_originals(name):
    from pose3d_tpu.core import cameras as jc

    want, got = getattr(jc, name), getattr(cameras, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_extrinsics_equal_the_original_for_every_subject_and_camera():
    from pose3d_tpu.core import cameras as jc

    for s in jc.SUBJECTS:
        for c in range(4):
            for got, want in zip(cameras.extrinsics(s, c), jc.extrinsics(s, c)):
                np.testing.assert_array_equal(got, want)
