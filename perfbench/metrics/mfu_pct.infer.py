"""The whole service's share of the bf16 peak: the model flops of the
frames requested in the window traced without host ops (padding not
counted; ``bounds.vit_frame_flops``) over its length times the peak."""


def read(ctx):
    if not ctx.device_info.get("frames"):
        return None
    flops = ctx.device_info["frames"] * ctx.bounds.vit_frame_flops(ctx.cfg)
    return 100.0 * flops / (ctx.device.window_s * ctx.bounds.PEAK_BF16)
