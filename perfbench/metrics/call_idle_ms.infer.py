"""call_idle_ms.infer: the predictor call's host stages, per program span
``sir.predict`` (the whole of ``predict_waveform_batch``) its length less
the union of the device operations inside it, the mean ms a call over the
traced slice."""

from core.records import union_length


def read(ctx):
    tr = ctx.trace
    calls = [(s, e) for name, s, e, _tid in tr.spans if name == "sir.predict"]
    if not calls:
        return None
    ops = [(o[1], o[2]) for o in tr.ops]
    idle = [(e - s) - union_length([(a, b) for a, b in ops if b > s and a < e],
                               s, e)
            for s, e in calls]
    return sum(idle) / len(idle) / 1e3
