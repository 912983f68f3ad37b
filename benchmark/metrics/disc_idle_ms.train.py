"""Device idle ms a step while the host was inside a discriminator's loss or
gradient (the ``disc_loss`` and ``disc_backward`` spans of
``make_train_step``): each idle µs of the profiled steps given to the
innermost program span open."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    from benchmark.program_spans import per_unit_ms

    return per_unit_ms(ctx, ["disc_loss", "disc_backward"], "step")
