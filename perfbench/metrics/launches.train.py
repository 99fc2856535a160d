"""Device operations (kernels, copies, sets) a train step launches,
counted in the window traced without host ops: the host's dispatch work,
which a wall clock cannot show while the launch queue is full."""


def read(ctx):
    steps = ctx.device_info.get("steps", 0)
    return ctx.device.n_device_events() / steps if steps else None
