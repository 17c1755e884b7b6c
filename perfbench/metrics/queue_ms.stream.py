"""queue_ms.stream: the server's queue, the mean ms from a
``StreamingRecognizer.feed`` that returns a pending result to the
``BatchFinalizer.flush`` that dispatches it (the drain tick's wait), over
the traced slice."""


def read(ctx):
    q = ctx.window.get("queue_s") or []
    return 1e3 * sum(q) / len(q) if q else None
