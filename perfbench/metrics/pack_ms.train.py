"""Device ms a step launched under the fused train forward's weight packs
(``pose3d.train.pack``: each half's casts and concatenation, 2 × n_blocks
a step), in the window traced with host ops, attributed by the program's
spans (``harness/spans.view``). The packs' backward runs on autograd's
thread, outside the span, and is not counted."""

from perfbench.harness import spans


def read(ctx):
    n = ctx.info.get("steps", 0)
    t = spans.view(__file__).group_s("pose3d.train.pack")
    return t * 1e3 / n if t and n else None
