"""The whole lift's share of the bf16 peak: the model flops of the clip
frames the program ran in the window traced without host ops (the
counter ``lift_sequence.clip_frames``, overlaps counted each time;
``bounds_video.clip_frame_flops``) over its length times the peak. None
where the program keeps no such counter."""

from perfbench.harness import bounds_video


def read(ctx):
    if not ctx.device_info.get("clip_frames"):
        return None
    flops = ctx.device_info["clip_frames"] * bounds_video.clip_frame_flops(ctx.cfg)
    return 100.0 * flops / (ctx.device.window_s * ctx.bounds.PEAK_BF16)
