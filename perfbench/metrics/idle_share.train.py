"""idle_share.train: 1 - the union of device operations' intervals over
the traced slice's wall time, in %."""


def read(ctx):
    return ctx.idle_share()
