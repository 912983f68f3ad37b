"""Device busy ms a training step in the profiled sub-window: the union of
the kernels' and copies' intervals over the steps profiled."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["busy_us"]:
        return None
    return ctx["busy_us"] / ctx["units"] / 1e3
