"""Data of the port: synthetic Human3.6M-like poses and the batch feed."""
