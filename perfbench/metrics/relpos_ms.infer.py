"""relpos_ms.infer: WavLM's gated relative position bias, the device time
of the kernels launched inside the program's ``sir.w2v.relpos`` spans (the
bias table's gather once a call, each layer's gate and gated bias), the
mean ms a call over the traced slice.  A program without the span (no
WavLM layer, or one from before the span) reads nothing."""


def read(ctx):
    kernels = ctx.trace.kernels_in("sir.w2v.relpos")
    calls = len(ctx.window["slice"]["calls"])
    if not kernels or not calls:
        return None
    return ctx.trace.seconds(kernels) * 1e3 / calls
