"""The port's Human3.6M data layer (``pose3d_tpu_torch/data/h36m.py``,
``data/stats.py``) against the JAX package's, on the CPU, on a fabricated
export in the genuine VideoPose3D schema (``torch_port_util.
write_fake_h36m``: subjects S1 and S5, actions "Walking 1" and "Posing",
the mono and the 4-camera files).

Both are numpy with the same expressions, so every output is held to
bitwise equality: ``read_data`` in each file mode, camera mode, action
filter and with frame paths; ``preprocess`` in every combination of its
flags (zero-centring, 2D and 3D standardisation, normalisation, 16 or 17
joints) and of its subsampling (``split_rate``, ``sample_n`` with its
seed), training split then evaluation split; the statistics, and their
files, which each package reads from the other.
"""

import itertools

import numpy as np
import pytest
import torch

from torch_port_util import write_fake_h36m

from pose3d_tpu_torch.data import h36m, stats

FRAMES = {("S1", "Walking 1"): 12, ("S1", "Posing"): 8,
          ("S5", "Walking 1"): 6, ("S5", "Posing"): 10}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("h36m")
    return root, write_fake_h36m(root, FRAMES, np.random.default_rng(0))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


READ_MODES = {
    "mono": {},
    "mono_paths": {"load_frame_paths": True},
    "cam0": {"mono_3d_file": False},
    "cam0_world": {"mono_3d_file": False, "camera_view": False},
    "all_cameras": {"mono_3d_file": False, "all_cameras": True},
    "all_cameras_paths": {"mono_3d_file": False, "all_cameras": True,
                          "load_frame_paths": True},
    "all_cameras_world": {"mono_3d_file": False, "all_cameras": True, "camera_view": False},
}


@pytest.mark.parametrize("mode", sorted(READ_MODES))
@pytest.mark.parametrize("action", ["", "Posing", "Walk"])
def test_read_data_equals_jax(tree, mode, action):
    from pose3d_tpu.data import h36m as jh

    root, _ = tree
    kw = READ_MODES[mode]
    got = h36m.read_data(root, ("S1", "S5"), action, **kw)
    want = jh.read_data(root, ("S1", "S5"), action, **kw)
    _equal(got, want)
    n_cams = 4 if kw.get("all_cameras") else 1
    n = sum(v for (s, a), v in FRAMES.items() if action in a) * n_cams
    assert got[1].shape == (n, 17, 3)


def test_read_data_of_no_frame_and_of_one_subject(tree):
    from pose3d_tpu.data import h36m as jh

    root, _ = tree
    _equal(h36m.read_data(root, ("S5",), "Sitting"), jh.read_data(root, ("S5",), "Sitting"))
    kp2d, kp3d, paths, cams = h36m.read_data(root, ("S5",), "Posing", load_frame_paths=True)
    assert kp3d.shape == (10, 17, 3) and cams.dtype == np.int32
    assert paths[0].endswith("videos/S5/outputVideos/Posing.mp4/0001.jpg")


def test_camera_view_is_the_quaternion_rotation(tree):
    """The 4-camera mode's 3D poses are the world poses rotated by each
    camera's extrinsics (the torch ``world_to_camera`` of ``core``)."""
    from pose3d_tpu_torch.core import cameras
    from pose3d_tpu_torch.core.skeleton import H36M_KEYPOINTS_FROM_32
    from pose3d_tpu_torch.core.transforms import world_to_camera

    root, data = tree
    _, kp3d, _, cams = h36m.read_data(root, ("S1",), "Posing", mono_3d_file=False,
                                      all_cameras=True)
    world = data["pos3d"]["S1"]["Posing"][:, list(H36M_KEYPOINTS_FROM_32)]
    for c in range(4):
        q, t = (torch.from_numpy(a) for a in cameras.extrinsics("S1", c))
        want = world_to_camera(torch.from_numpy(world).double(), q, t).float().numpy()
        np.testing.assert_allclose(kp3d[cams == c], want, atol=1e-5)


def test_reads_the_genuine_export_schema(tmp_path):
    """savez_compressed files with a 'metadata' entry in the 2D file, as
    the VideoPose3D scripts write them (``tests/test_h36m_reader.py``)."""
    from pose3d_tpu.data import h36m as jh

    rng = np.random.default_rng(1)
    (tmp_path / "npz").mkdir()
    pos3d = {"S1": {"Walking 1": rng.standard_normal((10, 32, 3)).astype(np.float32)}}
    pos2d = {"S1": {"Walking 1": rng.random((10, 32, 2)).astype(np.float32)}}
    np.savez_compressed(tmp_path / "npz" / "data_3d_h36m_mono.npz", positions_3d_mono=pos3d)
    np.savez_compressed(tmp_path / "npz" / "data_2d_h36m.npz", positions_2d=pos2d,
                        metadata={"layout_name": "h36m", "num_joints": 32})
    got = h36m.read_data(tmp_path, ("S1",), "")
    _equal(got, jh.read_data(tmp_path, ("S1",), ""))
    assert got[0].shape == (10, 17, 2)


FLAGS = ("zero_centre", "standardize_2d", "standardize_3d", "normalize")


def _preprocess_pair(root, tmp_path, subsample, flags, num_joints, all_cameras=False):
    """(port, JAX) datasets of the training split (S1) and then the
    evaluation split (S5, loading the training statistics), each package
    with its own statistics directory."""
    from pose3d_tpu.data import h36m as jh

    kw = dict(flags, num_joints=num_joints, **subsample)
    out = []
    for pkg, name in ((h36m, "port"), (jh, "jax")):
        split = []
        for subjects, is_train in ((("S1",), True), (("S5",), False)):
            kp2d, kp3d, paths, cams = pkg.read_data(
                root, subjects, "", mono_3d_file=False, all_cameras=all_cameras,
                load_frame_paths=True)
            split.append(pkg.preprocess(kp2d, kp3d, tmp_path / name, is_train=is_train,
                                        frame_paths=paths, cam_ids=cams, **kw))
        out.append(split)
    return out


def _dataset_equal(got, want):
    _equal([got.kp2d, got.kp3d, got.frame_paths, got.cam_ids],
           [want.kp2d, want.kp3d, want.frame_paths, want.cam_ids])
    for s_got, s_want in ((got.stats2d, want.stats2d), (got.stats3d, want.stats3d)):
        for field in ("mean", "std", "max", "min"):
            w = getattr(s_want, field)
            if w is None:
                assert getattr(s_got, field) is None
            else:
                np.testing.assert_array_equal(getattr(s_got, field), w)


@pytest.mark.parametrize("values", list(itertools.product((False, True), repeat=len(FLAGS))),
                         ids=lambda v: "".join("1" if b else "0" for b in v))
@pytest.mark.parametrize("num_joints", [17, 16])
def test_preprocess_flags_equal_jax(tree, tmp_path, values, num_joints):
    root, _ = tree
    port, jax_ = _preprocess_pair(root, tmp_path, {}, dict(zip(FLAGS, values)), num_joints)
    for got, want in zip(port, jax_):
        _dataset_equal(got, want)
        assert got.kp3d.shape[1] == num_joints
    if values[0] and num_joints == 17:
        assert not port[0].kp3d[:, 0].any()  # the root zeroed


@pytest.mark.parametrize("subsample", [{"split_rate": 3}, {"sample_n": 7, "sample_seed": 5},
                                       {"split_rate": 2, "sample_n": 9}],
                         ids=["split_rate", "sample_n", "both"])
def test_preprocess_subsampling_equals_jax(tree, tmp_path, subsample):
    root, _ = tree
    port, jax_ = _preprocess_pair(root, tmp_path, subsample, {"standardize_3d": True}, 17,
                                  all_cameras=True)
    for got, want in zip(port, jax_):
        _dataset_equal(got, want)
        assert len(got.frame_paths) == len(got) == len(got.cam_ids)
    if "sample_n" in subsample:
        assert len(port[0]) == subsample["sample_n"]


def test_stats_of_the_training_split_are_saved_and_loaded(tree, tmp_path):
    root, _ = tree
    kp2d, kp3d, _, _ = h36m.read_data(root, ("S1",), "")
    train = h36m.preprocess(kp2d, kp3d, tmp_path, is_train=True)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "max_train_3d.npy", "mean_train_2d.npy", "mean_train_3d.npy", "min_train_3d.npy",
        "std_train_2d.npy", "std_train_3d.npy"]
    ev = h36m.preprocess(kp2d[:4], kp3d[:4], tmp_path, is_train=False)
    np.testing.assert_array_equal(ev.stats3d.mean, train.stats3d.mean)
    assert train.stats3d.mean.dtype == np.float32 and train.stats3d.std.dtype == np.float64


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stats_files_load_in_the_other_package(tmp_path, writer):
    from pose3d_tpu.data import stats as js

    x3 = np.random.default_rng(2).standard_normal((50, 17, 3)).astype(np.float32)
    x2 = np.random.default_rng(3).random((50, 17, 2)).astype(np.float32)
    save, load = (stats, js) if writer == "port" else (js, stats)
    for x in (x2, x3):
        save.save_stats(save.compute_stats(x), tmp_path)
    for x, dim in ((x2, 2), (x3, 3)):
        want = js.compute_stats(x)
        got = load.load_stats(tmp_path, dim)
        for field in ("mean", "std", "max", "min"):
            w = getattr(want, field)
            if w is None:
                assert getattr(got, field) is None
            else:
                assert getattr(got, field).dtype == w.dtype
                np.testing.assert_array_equal(getattr(got, field), w)


@pytest.mark.parametrize("dim,normalize", [(2, False), (3, False), (2, True), (3, True)])
def test_standardize_and_destandardize_equal_jax(dim, normalize):
    """Forward on numpy, inverse on numpy and on a torch tensor (within f32
    rounding of the numpy inverse, on the tensor's dtype and device)."""
    from pose3d_tpu.data import stats as js

    x = np.random.default_rng(4).standard_normal((40, 17, dim)).astype(np.float32)
    st = stats.compute_stats(x)
    got = stats.standardize(x, st, normalize)
    want = js.standardize(x, js.compute_stats(x), normalize)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    back = stats.destandardize(got, st, normalize)
    np.testing.assert_array_equal(back, js.destandardize(want, js.compute_stats(x), normalize))
    np.testing.assert_allclose(back, x, atol=1e-5)
    t = stats.destandardize(torch.from_numpy(np.asarray(got, np.float32)), st, normalize)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), back, atol=1e-5)
