"""Human3.6M 17-joint skeleton constants: a copy of what the port reads
from ``pose3d_tpu/core/skeleton.py``."""

NUM_JOINTS = 17
