"""Device ms a step launched under the optimizer (``pose3d.train.optimizer``:
the global-norm clip where set, and AdamW's step), in the window traced
with host ops, attributed by the program's spans (``harness/spans.view``)."""

from perfbench.harness import spans


def read(ctx):
    n = ctx.info.get("steps", 0)
    t = spans.view(__file__).group_s("pose3d.train.optimizer")
    return t * 1e3 / n if t and n else None
