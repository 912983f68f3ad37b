"""Device idle ms a step while the host was inside the generator's forward
or its loss (the ``generator`` and ``gen_loss`` spans of
``make_train_step``: the waveform terms and the MPD's feature passes): each
idle µs of the profiled steps given to the innermost program span open."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    from benchmark.program_spans import per_unit_ms

    return per_unit_ms(ctx, ["generator", "gen_loss"], "step")
