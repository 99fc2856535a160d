"""The ViT trunk kernels' share of their roofline: the sum of every
trunk call's bound at its bucket (``bounds.trunk_call_bound``) over the
device time of the ``trunk`` group's launches."""


def read(ctx):
    t = ctx.trace.group_s("trunk")
    if not t or not ctx.info.get("calls"):
        return None
    return 100.0 * sum(ctx.bounds.trunk_call_bound(ctx.cfg, b)[0] for b in ctx.info["calls"]) / t
