"""Share of wall time in which no kernel or copy ran on the device: the
device time of the profiled requests (the union of their kernels' and
copies' intervals) over the wall time the same requests took in the traced
run's measured window, where no profiler slowed the host."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["busy_us"] or not ctx["unprofiled_wall_us"]:
        return None
    return 1.0 - ctx["busy_us"] / ctx["unprofiled_wall_us"]
