"""attention_roofline.infer: the wav2vec attention core of every layer,
from q, k and v to the heads' output with WavLM's gated bias added to the
scores, the kernels launched inside the program's ``sir.w2v.attention``
spans (``work`` layer ``attention``: the least any implementation moves,
no (B, heads, T, T) tensor written)."""


def read(ctx):
    return ctx.roofline("attention", ctx.trace.kernels_in("sir.w2v.attention"))
