"""Device-idle ms a video while ``lift_sequence`` cuts its clips
(``pose3d.lift_sequence.clips``: the normalisation, the clips, the copy
in) and averages them (``pose3d.lift_sequence.average``: the copy out,
the overlap mean), in the window traced with host ops
(``harness/spans.idle_ms``, summed over both spans). None where the
program records neither."""

from perfbench.harness import spans


def read(ctx):
    idle = [spans.idle_ms(ctx, name) for name in ("pose3d.lift_sequence.clips",
                                                  "pose3d.lift_sequence.average")]
    idle = [v for v in idle if v is not None]
    return sum(idle) if idle else None
