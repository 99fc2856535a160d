"""Device-idle ms a request while the service fetches its chunks' poses
(``pose3d.serve.fetch``: the cast, the copy out, the write into the
answer), in the window traced with host ops: the wait on the way out
(``harness/spans.idle_ms``)."""

from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "pose3d.serve.fetch")
