"""The whole train step's share of the bf16 peak: the model flops of the
steps in the window traced without host ops (3 forwards a step;
``bounds.temporal_step_flops``) over its length times the peak."""


def read(ctx):
    if not ctx.device_info.get("steps"):
        return None
    flops = ctx.device_info["steps"] * ctx.bounds.temporal_step_flops(ctx.cfg,
                                                                       ctx.device_info["clips"])
    return 100.0 * flops / (ctx.device.window_s * ctx.bounds.PEAK_BF16)
