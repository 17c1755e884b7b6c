"""deliver_ms.stream: the server's delivery, the mean ms from the flush
that dispatched an utterance's finalize to the writing of its result line
(the program's ``utterance`` records: connection, session, ordinal,
t_submit, t_dispatch, t_sent), over the traced slice's records that hold
both."""

from core.records import records


def read(ctx):
    waits = [sent - dispatched
             for *_id, _submit, dispatched, sent in records("utterance")
             if dispatched is not None and sent is not None]
    return sum(waits) / len(waits) / 1e6 if waits else None
