"""Device busy ms a request: the union of the kernels' and copies'
intervals of the profiled requests (the measured window's first ones,
replayed), over their count."""


def read(ctx):
    if ctx["kind"] != "classify" or not ctx["busy_us"]:
        return None
    return ctx["busy_us"] / ctx["units"] / 1e3
