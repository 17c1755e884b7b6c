"""mfu.infer: the whole serving step's share of the chip's peak, from the
window: every call's model operations (``work/<config>.py``), at each
precision's dense H100 peak, over the window's wall time, in %."""


def read(ctx):
    return ctx.mfu()
