"""k1_roofline.infer: K1, the front-end + conv1 kernel, against the least
time of the log-mel front-end and conv1 (``work`` layer ``k1``).  K1 runs
inside ``ServingBody.forward``, where no module boundary separates it, so
its kernels are found by name."""

PATTERN = r"frontend_conv1"


def read(ctx):
    return ctx.roofline("k1", ctx.trace.kernels_named(PATTERN))
