"""Inference pipelines of the port (keypoints in, 3D poses out)."""
