"""Device ms a video under the DSTformer's stream fusions (the program's
span ``pose3d.temporal.fuse``, one a layer), in the window traced with
host ops (``harness/spans_video.view``). None where the program records
no such span."""

from perfbench.harness import spans_video


def read(ctx):
    n = ctx.info.get("requests", 0)
    t = spans_video.view(__file__).group_s(spans_video.FUSE)
    return t * 1e3 / n if t and n else None
