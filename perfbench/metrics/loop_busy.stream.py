"""loop_busy.stream: the server's event loop, 100 x the union of the
program's ``sir.server.message`` spans (a client line: decode, ``feed``,
submit) and ``sir.server.tick`` spans (a drain pass that flushed or sent)
on the loop's thread, over the traced slice, in %."""

from collections import Counter

from core.records import union_length

SPANS = ("sir.server.message", "sir.server.tick")


def read(ctx):
    tr = ctx.trace
    spans = [(s, e, tid) for name, s, e, tid in tr.spans if name in SPANS]
    if not spans or tr.window_s <= 0:
        return None
    loop = Counter(tid for _s, _e, tid in spans).most_common(1)[0][0]
    busy = union_length([(s, e) for s, e, tid in spans if tid == loop],
                    tr.start, tr.end)
    return 100.0 * busy / 1e6 / tr.window_s
