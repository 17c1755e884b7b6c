"""feed_us.stream: the streaming host path, the mean host us of a
``StreamingRecognizer.feed`` (voice detector, featurizer, and the submit
of a finished utterance), over the traced slice."""


def read(ctx):
    spans = [e - s for name, s, e, _t in ctx.trace.spans
             if name == "StreamingRecognizer.feed"]
    return sum(spans) / len(spans) if spans else None
