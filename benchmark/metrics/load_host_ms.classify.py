"""Host ms a request in the program's ``load`` span (``Classifier.classify``
around ``load_input``: the uint8 images' copy to the device and their
normalisation there), over the profiled sub-window's requests."""


def read(ctx):
    if ctx["kind"] != "classify":
        return None
    from benchmark.program_spans import host_us, outermost, recorded

    spans = recorded()
    requests = spans and outermost(spans, "request")
    if not requests:
        return None
    return host_us(spans, "load") / len(requests) / 1e3
