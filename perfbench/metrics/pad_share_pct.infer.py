"""The share of the frames the service ran that were bucket padding:
100 × ``LifterService.frames_padded`` over ``frames_served`` +
``frames_padded``, the process's totals when the reader runs: both traced
windows and set-up's one request a bucket (16,320 frames, each filling its
bucket, so no padding; under 0.5% of a traced run's frames). None where
the service keeps no such counters."""

from pose3d_tpu_torch.serving import LifterService


def read(ctx):
    served = getattr(LifterService, "frames_served", None)
    padded = getattr(LifterService, "frames_padded", None)
    if served is None or padded is None or not served + padded:
        return None
    return 100.0 * padded / (served + padded)
