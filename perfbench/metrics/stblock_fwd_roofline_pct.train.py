"""The training sub-block forwards' share of their roofline: every
step's blocks' spatial and temporal forward bounds
(``bounds.sub_block_fwd_bounds``) over the device time of the
``stblock_fwd`` group."""


def read(ctx):
    t = ctx.trace.group_s("stblock_fwd")
    if not t or not ctx.info.get("steps"):
        return None
    per_block = sum(b for b, _ in ctx.bounds.sub_block_fwd_bounds(ctx.cfg, ctx.info["clips"]).values())
    return 100.0 * ctx.info["steps"] * ctx.cfg["n_blocks"] * per_block / t
