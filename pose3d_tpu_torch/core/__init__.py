"""The port's pose-space core: copies of the numpy tables of
``pose3d_tpu/core`` (that package's ``__init__`` imports JAX), and its
quaternion and transform functions on torch tensors."""
