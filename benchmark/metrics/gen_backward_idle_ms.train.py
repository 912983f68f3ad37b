"""Device idle ms a step while the host was inside the generator's gradient
(the ``gen_backward`` span of ``make_train_step``: autograd's backward of the
generator loss): each idle µs of the profiled steps given to the innermost
program span open."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    from benchmark.program_spans import per_unit_ms

    return per_unit_ms(ctx, ["gen_backward"], "step")
