"""Human3.6M camera intrinsics, indexed by camera id 0..3: a copy of the
tables the port reads from ``pose3d_tpu/core/cameras.py`` (public H36M
calibration metadata)."""

from __future__ import annotations

import numpy as np

CENTER = np.array(
    [
        [512.54150390625, 515.4514770507812],
        [508.8486328125, 508.0649108886719],
        [519.8158569335938, 501.40264892578125],
        [514.9682006835938, 501.88201904296875],
    ],
    dtype=np.float64,
)

FOCAL_LENGTH = np.array(
    [
        [1145.0494384765625, 1143.7811279296875],
        [1149.6756591796875, 1147.5916748046875],
        [1149.1407470703125, 1148.7989501953125],
        [1145.5113525390625, 1144.77392578125],
    ],
    dtype=np.float64,
)
