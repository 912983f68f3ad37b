"""Host ms a request in the program's ``save`` span (``Inferencer.infer_file``:
the copy back to the host and the enhanced wav written), over the profiled
sub-window's requests."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    from benchmark.program_spans import host_us, outermost, recorded

    spans = recorded()
    requests = spans and outermost(spans, "request")
    if not requests:
        return None
    return host_us(spans, "save") / len(requests) / 1e3
