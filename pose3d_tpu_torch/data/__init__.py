"""Data of the port: the Human3.6M keypoint reader and its statistics,
synthetic Human3.6M-like poses and the batch feed."""
