"""The scan kernels' share of their HBM roofline while serving: the least
bytes of every scan call of the profiled requests' segments (each input
read once, each output written once, in the scan's activation dtype) over
the card's HBM bytes/s, as a share of the device time of the kernels named
below (the fused scan forward and the linear recurrence forward)."""

KERNELS = (
    "vmasr::(anonymous namespace)::fused_fwd_kernel<",
    "vmasr::(anonymous namespace)::lr_scan_kernel<false,",
)


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["peaks"]:
        return None
    from benchmark.trace import matching_us

    us = matching_us(ctx["device"], KERNELS)
    if not us:
        return None
    return 100.0 * ctx["scan_bytes"] / ctx["peaks"]["hbm_bytes_per_s"] / (us * 1e-6)
