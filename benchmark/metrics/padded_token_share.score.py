"""Share of the positions the model ran that were padding: the sum of
(bucket_tokens − tokens) over the sum of bucket_tokens, over the ``lm``
spans of the profiled requests (their counts, ``Scorer.score``)."""


def read(ctx):
    if ctx["kind"] != "score":
        return None
    from benchmark.program_spans import recorded

    spans = recorded()
    forwards = [s.counts for s in spans or () if s.name == "lm"]
    positions = sum(c["bucket_tokens"] for c in forwards)
    if not positions:
        return None
    return sum(c["bucket_tokens"] - c["tokens"] for c in forwards) / positions
