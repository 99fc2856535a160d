"""Training of the port: optimizer and plateau state, steps, checkpoints
and metric logging (the counterparts of ``pose3d_tpu/train``)."""
