"""encoder_roofline.infer: wav2vec's feature encoder, the 7 convolutions
with their norm and GELUs, the kernels launched inside the
``FeatureEncoder`` span (``work`` layer ``encoder``)."""


def read(ctx):
    return ctx.roofline("encoder", ctx.trace.kernels_in("FeatureEncoder"))
