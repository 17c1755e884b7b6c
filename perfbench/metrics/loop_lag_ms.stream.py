"""loop_lag_ms.stream: the server's event loop, the mean ms by which a
drain loop's timed wait returned after it was due (the program's ``tick``
records: connection, due, woke), over the traced slice."""

from core.records import records


def read(ctx):
    ticks = records("tick")
    if not ticks:
        return None
    return sum(woke - due for _c, due, woke in ticks) / len(ticks) / 1e6
