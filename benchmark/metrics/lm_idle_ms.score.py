"""Device idle ms a request while the host was inside the ``lm`` span
(``Scorer.score`` around the forward, a CUDA graph's replay on the card):
each idle µs of the profiled requests given to the innermost program span
open at that µs."""


def read(ctx):
    if ctx["kind"] != "score":
        return None
    from benchmark.program_spans import per_unit_ms

    return per_unit_ms(ctx, ["lm"], "request")
