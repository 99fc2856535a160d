"""Device-idle ms a request while the service stages its chunks
(``pose3d.serve.stage``: the numpy slice, the bucket, the zero-filled
bucket, the copy in), in the window traced with host ops: the wait on the
way in (``harness/spans.idle_ms``)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "pose3d.serve.stage")
