"""gru_roofline.infer: the GRU's input products and recurrence (K2 for
each layer), the kernels launched inside the ``TorchGRU`` span (``work``
layer ``gru``)."""


def read(ctx):
    return ctx.roofline("gru", ctx.trace.kernels_in("TorchGRU"))
