"""conv_roofline.infer: conv2 and conv3 with their epilogues (``work``
layer ``conv``): the kernels launched inside the ``CNNAudioGRU`` span
before its ``TorchGRU`` span begins (the head runs after the GRU)."""


def read(ctx):
    tr = ctx.trace
    gru_starts = tr.span_starts("TorchGRU")
    model = [(s, e, tid) for name, s, e, tid in tr.spans
             if name == "CNNAudioGRU"]
    kernels = []
    for k in tr.kernels_in("CNNAudioGRU"):
        ts, tid = tr.launch[id(k)]
        for s, e, t in model:
            if t == tid and s <= ts <= e:
                first_gru = min((g for g in gru_starts if s <= g <= e),
                                default=e)
                if ts < first_gru:
                    kernels.append(k)
                break
    return ctx.roofline("conv", kernels)
