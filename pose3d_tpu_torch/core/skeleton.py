"""Human3.6M 17-joint skeleton constants and the COCO -> H36M joint remap:
a copy of ``pose3d_tpu/core/skeleton.py``'s tables (that package's
``__init__`` imports JAX), with ``coco_to_h36m`` on numpy arrays and torch
tensors."""

from __future__ import annotations

import numpy as np
import torch

NUM_JOINTS = 17

# indices into the raw 32-joint Human3.6M export of the 17-joint skeleton
H36M_KEYPOINTS_FROM_32 = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)

JOINT_NAMES = (
    "root", "rhip", "rkne", "rank", "lhip", "lkne", "lank", "belly",
    "neck", "nose", "head", "lsho", "lelb", "lwri", "rsho", "relb", "rwri",
)

# bone segments for rendering, the reference's duplicated (5, 6) edge kept
BONES = (
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (5, 6), (0, 7), (7, 8),
    (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15), (15, 16),
)

LEFT_JOINTS = (4, 5, 6, 11, 12, 13)
RIGHT_JOINTS = (1, 2, 3, 14, 15, 16)

# swaps left <-> right joints, identity elsewhere
FLIP_PERMUTATION = tuple(
    dict(zip(LEFT_JOINTS + RIGHT_JOINTS, RIGHT_JOINTS + LEFT_JOINTS)).get(j, j)
    for j in range(NUM_JOINTS)
)


def _build_coco_to_h36m_matrix() -> np.ndarray:
    """(17, 17) M with h36m = M @ coco. COCO order: 0 nose, 1-2 eyes (L, R),
    3-4 ears, 5-6 shoulders, 7-8 elbows, 9-10 wrists, 11-12 hips, 13-14
    knees, 15-16 ankles. Root, neck and head are midpoints; belly is the
    midpoint of root and neck."""
    m = np.zeros((NUM_JOINTS, NUM_JOINTS), dtype=np.float64)
    m[0, 11] = m[0, 12] = 0.5          # root = (Lhip + Rhip) / 2
    m[1, 12] = 1.0                     # rhip
    m[2, 14] = 1.0                     # rkne
    m[3, 16] = 1.0                     # rank
    m[4, 11] = 1.0                     # lhip
    m[5, 13] = 1.0                     # lkne
    m[6, 15] = 1.0                     # lank
    m[8, 5] = m[8, 6] = 0.5            # neck = (Lsho + Rsho) / 2
    m[7] = 0.5 * (m[0] + m[8])         # belly = (root + neck) / 2
    m[9, 0] = 1.0                      # nose
    m[10, 1] = m[10, 2] = 0.5          # head = (Leye + Reye) / 2
    m[11, 5] = 1.0                     # lsho
    m[12, 7] = 1.0                     # lelb
    m[13, 9] = 1.0                     # lwri
    m[14, 6] = 1.0                     # rsho
    m[15, 8] = 1.0                     # relb
    m[16, 10] = 1.0                    # rwri
    return m


COCO_TO_H36M_MATRIX = _build_coco_to_h36m_matrix()


def coco_to_h36m(x):
    """COCO-ordered (..., 17, C) keypoints -> H36M order (y = M @ x per
    frame), on a numpy array or a torch tensor of any device."""
    if isinstance(x, np.ndarray):
        return COCO_TO_H36M_MATRIX.astype(x.dtype) @ x
    return torch.as_tensor(COCO_TO_H36M_MATRIX, dtype=x.dtype, device=x.device) @ x
