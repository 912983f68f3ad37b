"""The scan kernels' share of their HBM roofline in training: the least
bytes of every scan call of the profiled steps, forward and backward (each
input read once, each output written once, in the scan's activation
dtype), over the card's HBM bytes/s, as a share of the device time of the
kernels named below (the fused scan forward and its backward's passes, the
linear recurrence forward and reverse)."""

KERNELS = (
    "vmasr::(anonymous namespace)::fused_fwd_kernel<",
    "vmasr::(anonymous namespace)::bwd_fold_kernel<",
    "vmasr::chunk_carry_kernel(",
    "vmasr::(anonymous namespace)::bwd_tile_kernel<",
    "vmasr::(anonymous namespace)::reduce_rows_kernel(",
    "vmasr::(anonymous namespace)::lr_scan_kernel<",
)


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peaks"]:
        return None
    from benchmark.trace import matching_us

    us = matching_us(ctx["device"], KERNELS)
    if not us:
        return None
    return 100.0 * ctx["scan_bytes"] / ctx["peaks"]["hbm_bytes_per_s"] / (us * 1e-6)
