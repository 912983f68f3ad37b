"""Share of the profiled requests' ``generator`` spans (one bucket's forward
each) whose forward was a CUDA graph's replay: the program adds
``graph_replays`` to the span, 1 for a replay and 0 for an eager forward.
A program whose spans carry no such count gives nothing."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    from benchmark.program_spans import recorded

    forwards = [s.counts for s in recorded() or () if s.name == "generator"]
    if not any("graph_replays" in c for c in forwards):
        return None
    return sum(c.get("graph_replays", 0) for c in forwards) / len(forwards)
