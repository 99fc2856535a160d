"""Device ms a request in work launched by PyTorch ops (the embed, the
head, the padding zeros, the host copies): the ``aten`` group of the
trace's attribution."""


def read(ctx):
    n = ctx.info.get("requests", 0)
    return ctx.trace.group_s("aten") * 1e3 / n if n else None
