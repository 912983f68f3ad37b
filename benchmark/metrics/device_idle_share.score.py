"""Share of the profiled requests' wall time in which no kernel or copy
ran on the device: 1 − the union of their kernels' and copies' intervals
over the profiled window that holds them, both read from the same trace,
so that the share lies in [0, 1]."""


def read(ctx):
    if ctx["kind"] != "score" or not ctx["busy_us"] or not ctx["window_s"]:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
