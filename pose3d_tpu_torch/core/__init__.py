"""Port-local copies of the numpy tables of ``pose3d_tpu/core`` that the
port reads (that package's ``__init__`` imports JAX)."""
