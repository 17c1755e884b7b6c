"""optimizer_ms.train: the optimizer (global-norm clip and Adam), the
device ms of the kernels launched inside the ``Optimizer.step`` span, per
step of the traced slice."""


def read(ctx):
    steps = len(ctx.trace.span_starts("Optimizer.step"))
    kernels = ctx.trace.kernels_in("Optimizer.step")
    if not steps or not kernels:
        return None
    return 1e3 * ctx.trace.seconds(kernels) / steps
