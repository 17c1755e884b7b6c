"""mfu.train: the whole training step's share of the chip's peak, from the
window: three times the forward operations of every layer after the
front-end, a row (``work`` ``train_layers``), at each precision's dense
H100 peak, over the window's wall time, in %."""


def read(ctx):
    return ctx.mfu()
