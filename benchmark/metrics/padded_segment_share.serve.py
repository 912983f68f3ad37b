"""Share of the rows the generator ran that were padding: the sum of
(bucket − real segments) over the sum of buckets, over the ``generator``
spans of the profiled requests (their ``bucket`` and ``segments`` counts)."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    from benchmark.program_spans import recorded

    spans = recorded()
    forwards = [s.counts for s in spans or () if s.name == "generator"]
    rows = sum(c["bucket"] for c in forwards)
    if not rows:
        return None
    return sum(c["bucket"] - c["segments"] for c in forwards) / rows
