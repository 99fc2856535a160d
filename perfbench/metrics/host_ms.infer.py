"""Host time a request adds where the device waits: the window traced
without host ops, less the device's busy time in it, over its requests.
The service's host work (buckets, padding, copies, numpy) that no device
work hides."""


def read(ctx):
    n = ctx.device_info.get("requests", 0)
    return (ctx.device.window_s - ctx.device.busy_s) * 1e3 / n if n else None
