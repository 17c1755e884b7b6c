"""transformer_roofline.infer: wav2vec's positional convolution and its
12 encoder layers, the kernels launched inside the ``Encoder`` span
(``work`` layer ``transformer``)."""


def read(ctx):
    return ctx.roofline("transformer", ctx.trace.kernels_in("Encoder"))
