"""Mean host time of a request outside the generator's forwards: the wav
read, resampled and padded, the copies, and the enhanced wav written.
Spans of the traced run's measured window: each ``request`` less its
``forward`` (``Inferencer.forward_chunked``, synchronised at its end, so
that the device's work falls inside it)."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["requests"]:
        return None
    return (ctx["request_s"] - ctx["forward_s"]) / ctx["requests"] * 1e3
