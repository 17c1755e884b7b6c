"""bn_pool_ms.train: the training conv epilogue (the three conv stages'
BatchNorm, ReLU and 2x2 max-pool, forward and backward), the device ms of
the kernels launched inside the program's ``sir.conv.bn_pool`` and
``sir.conv.bn_pool.backward`` spans, per step of the traced slice.  A
program without the spans reads nothing."""


def read(ctx):
    tr = ctx.trace
    kernels = (tr.kernels_in("sir.conv.bn_pool")
               + tr.kernels_in("sir.conv.bn_pool.backward"))
    steps = len(ctx.window["slice"]["calls"]) * ctx.traffic["steps_per_call"]
    if not kernels or not steps:
        return None
    return 1e3 * tr.seconds(kernels) / steps
