"""Human3.6M keypoint dataset: the port of ``pose3d_tpu/data/h36m.py``, in
numpy as there (the reference's ``H36_dataset.py`` without its Python
loops).

- ``read_data`` loads the VideoPose3D-format npz exports
  (``<data_dir>/npz/data_2d_h36m.npz`` and ``data_3d_h36m{,_mono}.npz``),
  keeps the 17 joints of the 32, and in the 4-camera file mode rotates the
  world-frame 3D poses into one camera (or, with ``all_cameras``, all
  four). ``action`` filters by substring, as the reference does.
- ``preprocess`` subsamples (``split_rate``, or ``sample_n`` frames drawn
  with an explicit seed), zero-centres the 3D poses, computes and saves
  (training split) or loads (evaluation split) the statistics, optionally
  standardises, and drops the root in the 16-joint mode.

The reference's ground-truth box crop keeps the whole frame, so there is
none here either.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from pose3d_tpu_torch.core import cameras as cam_tables
from pose3d_tpu_torch.core.skeleton import H36M_KEYPOINTS_FROM_32
from pose3d_tpu_torch.data import stats as stats_lib

TRAIN_SUBJECTS = ("S1", "S5", "S6", "S7", "S8")
TEST_SUBJECTS = ("S9", "S11")
CAM_SUFFIXES = (".54138969", ".55011271", ".58860488", ".60457274")


@dataclasses.dataclass
class KeypointDataset:
    """Flat frame-major arrays."""

    kp2d: np.ndarray            # (N, J, 2) float32
    kp3d: np.ndarray            # (N, J, 3) float32
    frame_paths: list | None    # N frame image paths, or None
    cam_ids: np.ndarray | None  # (N,) int32 camera index 0..3
    stats2d: stats_lib.NormStats | None = None
    stats3d: stats_lib.NormStats | None = None

    def __len__(self):
        return self.kp3d.shape[0]


def _np_world_to_camera(points, orientation, translation_mm):
    """World-frame (..., 3) points -> camera frame, for one camera's
    orientation (4,) wxyz and translation (3,) in mm."""
    p = points - translation_mm / 1000.0
    w, x, y, z = orientation
    r = np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * w * y + 2 * x * z],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z, 1 - 2 * x * x - 2 * y * y],
    ])
    return p @ r.T


def _frame_paths(data_dir, subject: str, video: str, n: int) -> list[str]:
    return [str(data_dir / "videos" / subject / "outputVideos" / f"{video}.mp4" / f"{i + 1:04d}.jpg")
            for i in range(n)]


def read_data(data_dir, subjects=TRAIN_SUBJECTS, action: str = "", mono_3d_file: bool = True,
              camera_view: bool = True, all_cameras: bool = False,
              load_frame_paths: bool = False):
    """-> (kp2d (N, 17, 2), kp3d (N, 17, 3), frame paths or None, camera ids
    (N,)), float32 and int32. In the mono mode the 3D file is already per
    camera (camera 0); otherwise the world-frame pose goes into camera 0,
    or into each of the four with ``all_cameras``, unless ``camera_view``
    is off."""
    data_dir = pathlib.Path(data_dir)
    path_2d = data_dir / "npz" / "data_2d_h36m.npz"
    path_3d = data_dir / "npz" / ("data_3d_h36m_mono.npz" if mono_3d_file
                                  else "data_3d_h36m.npz")
    key_3d = "positions_3d_mono" if mono_3d_file else "positions_3d"
    data_3d = np.load(path_3d, allow_pickle=True)[key_3d].item()
    data_2d = np.load(path_2d, allow_pickle=True)["positions_2d"].item()

    sel = list(H36M_KEYPOINTS_FROM_32)
    chunks_2d, chunks_3d, paths, cam_ids = [], [], [], []
    n_cams = 4 if (all_cameras and not mono_3d_file) else 1
    for s in subjects:
        for a in data_3d[s]:
            if action not in a:
                continue
            pose_3d = np.asarray(data_3d[s][a], dtype=np.float32)[:, sel]
            if mono_3d_file:
                chunks_3d.append(pose_3d)
                chunks_2d.append(np.asarray(data_2d[s][a], dtype=np.float32)[:, sel])
                cam_ids.append(np.zeros(len(pose_3d), np.int32))
                if load_frame_paths:
                    paths.extend(_frame_paths(data_dir, s, a, len(pose_3d)))
                continue
            for c in range(n_cams):
                pose_c = pose_3d
                if camera_view:
                    q, t = cam_tables.extrinsics(s, c)
                    pose_c = _np_world_to_camera(pose_3d, q, t).astype(np.float32)
                chunks_3d.append(pose_c)
                chunks_2d.append(np.asarray(data_2d[s][a + CAM_SUFFIXES[c]],
                                            dtype=np.float32)[:, sel])
                cam_ids.append(np.full(len(pose_c), c, np.int32))
                if load_frame_paths:
                    paths.extend(_frame_paths(data_dir, s, a + CAM_SUFFIXES[c], len(pose_c)))

    kp2d = np.concatenate(chunks_2d) if chunks_2d else np.zeros((0, 17, 2), np.float32)
    kp3d = np.concatenate(chunks_3d) if chunks_3d else np.zeros((0, 17, 3), np.float32)
    cam = np.concatenate(cam_ids) if cam_ids else np.zeros((0,), np.int32)
    return kp2d, kp3d, (paths if load_frame_paths else None), cam


def preprocess(kp2d: np.ndarray, kp3d: np.ndarray, stats_dir, is_train: bool = True,
               zero_centre: bool = True, standardize_2d: bool = False,
               standardize_3d: bool = False, normalize: bool = False, num_joints: int = 17,
               split_rate: int | None = None, sample_n: int | None = None,
               sample_seed: int = 0, frame_paths=None, cam_ids=None) -> KeypointDataset:
    """The reference dataset's processing, in its order: ``split_rate``
    subsampling, then ``sample_n`` random frames (``sample_seed``), the
    3D zero-centring, the statistics (computed and saved under
    ``stats_dir`` for a training split, loaded for an evaluation split),
    standardisation, and the root dropped (16 joints) or zeroed."""
    if split_rate:
        kp2d, kp3d = kp2d[::split_rate], kp3d[::split_rate]
        if frame_paths is not None:
            frame_paths = frame_paths[::split_rate]
        if cam_ids is not None:
            cam_ids = cam_ids[::split_rate]
    if sample_n:
        idx = np.random.default_rng(sample_seed).integers(0, len(kp3d), sample_n)
        kp2d, kp3d = kp2d[idx], kp3d[idx]
        if frame_paths is not None:
            frame_paths = [frame_paths[i] for i in idx]
        if cam_ids is not None:
            cam_ids = cam_ids[idx]
    kp2d, kp3d = kp2d.copy(), kp3d.copy()

    if zero_centre:
        kp3d[:, 1:] -= kp3d[:, :1]

    if is_train:
        s2, s3 = stats_lib.compute_stats(kp2d), stats_lib.compute_stats(kp3d)
        stats_lib.save_stats(s2, stats_dir)
        stats_lib.save_stats(s3, stats_dir)
    else:
        s2, s3 = stats_lib.load_stats(stats_dir, 2), stats_lib.load_stats(stats_dir, 3)

    if standardize_2d:
        kp2d = stats_lib.standardize(kp2d, s2, normalize=normalize)
    if standardize_3d:
        kp3d = stats_lib.standardize(kp3d, s3, normalize=normalize)

    if num_joints == 16:
        kp2d, kp3d = kp2d[:, 1:], kp3d[:, 1:]
    elif zero_centre:
        kp3d[:, :1] *= 0

    return KeypointDataset(kp2d=kp2d, kp3d=kp3d, frame_paths=frame_paths, cam_ids=cam_ids,
                           stats2d=s2, stats3d=s3)
