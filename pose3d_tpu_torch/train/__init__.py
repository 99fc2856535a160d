"""Training of the port: optimizer and plateau state, steps, epochs,
checkpoints, metric logging and debug hooks (the counterparts of
``pose3d_tpu/train``)."""
