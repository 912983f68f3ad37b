"""Host ms a request in the program's ``load`` span (``Inferencer.infer_file``
around ``load_input``: the wav read, the resample, the pad and the copy to
the device), over the profiled sub-window's requests."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    from benchmark.program_spans import host_us, outermost, recorded

    spans = recorded()
    requests = spans and outermost(spans, "request")
    if not requests:
        return None
    return host_us(spans, "load") / len(requests) / 1e3
