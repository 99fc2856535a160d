"""The device's idle share of the window traced without host ops: the
window less the union of every device activity (kernels, copies, sets),
over the window."""


def read(ctx):
    return ctx.device.idle_pct()
