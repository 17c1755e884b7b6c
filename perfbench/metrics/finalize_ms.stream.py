"""finalize_ms.stream: the batched finalize, the mean ms from the start of
a ``BatchFinalizer.flush`` that dispatches work to the end of the last
device operation it launched (the copy of the probabilities to the host),
over the traced slice."""


def read(ctx):
    times = [(max(o[2] for o in ops) - start) / 1e3
             for start, _end, ops in ctx.trace.per_span("BatchFinalizer.flush")
             if ops]
    return sum(times) / len(times) if times else None
