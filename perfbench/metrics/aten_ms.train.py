"""Device ms a step in work launched by PyTorch ops (cuBLAS, elementwise,
the loss, AdamW, the batch's copy): the ``aten`` group of the trace's
attribution."""


def read(ctx):
    n = ctx.info.get("steps", 0)
    return ctx.trace.group_s("aten") * 1e3 / n if n else None
