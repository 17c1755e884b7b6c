"""gru_roofline.train: the GRU forward and backward (input products, K2,
K2T and the weight gradients): the kernels launched inside the
``TorchGRU`` span and the ``TorchGRU.backward`` span, against three times
the forward's work (``work`` ``train_layers``, layer ``gru``)."""


def read(ctx):
    tr = ctx.trace
    return ctx.roofline("gru", tr.kernels_in("TorchGRU")
                        + tr.kernels_in("TorchGRU.backward"))
