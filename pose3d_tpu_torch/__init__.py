"""pose3d_tpu_torch: the PyTorch/CUDA port of ``pose3d_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch on an NVIDIA Hopper GPU, and every Pallas kernel on
a ported path becomes a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound through ``ctypes``.

Ported so far: the lifter serving path.

- ``models/lifters.py``  ``JointTransformerLifter`` (the reference MyViT).
- ``interop/weights.py`` flax param tree -> the port's state dict.
- ``ops/attention.py``   plain per-frame attention math (clamped softmax).
- ``ops/lifter.py``      the fused trunk: kernel wrapper + plain version.
- ``serving.py``         ``LifterService``: bucketed batch inference.

The package imports torch and numpy, never jax, flax or ``pose3d_tpu``.
"""

__version__ = "0.1.0"
