"""Device idle ms a request while the host was inside a ``generator`` span
(one bucket's forward, launched by ``bucketed_forward`` or the single-segment
path of ``Inferencer.forward_chunked``): each idle µs of the profiled
requests given to the innermost program span open at that µs."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    from benchmark.program_spans import per_unit_ms

    return per_unit_ms(ctx, ["generator"], "request")
