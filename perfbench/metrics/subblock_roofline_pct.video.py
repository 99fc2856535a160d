"""The served sub-blocks' share of their roofline: the bound of every
sub-block of every video of the window traced with host ops
(``bounds_video.trunk_bound_s`` at each video's clip count) over the
device time under the program's span ``pose3d.temporal.trunk`` (the
``temporal_trunk`` group) less that under ``pose3d.temporal.fuse`` (the
stream fusions, ``harness/spans_video.view``). The bound reads the same
work whatever implements it. None where the program records no trunk
span."""

from perfbench.harness import bounds_video, spans_video


def read(ctx):
    trunk = ctx.trace.group_s("temporal_trunk")
    if not trunk or not ctx.info.get("clips"):
        return None
    t = trunk - spans_video.view(__file__).group_s(spans_video.FUSE)
    bound = sum(bounds_video.trunk_bound_s(ctx.cfg, c) for c in ctx.info["clips"])
    return 100.0 * bound / t if t > 0 else None
