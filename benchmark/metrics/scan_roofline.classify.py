"""The selective scan's share of its HBM roofline in the classifier: the
least bytes of every scan call of the profiled requests (u, Δ and y once,
B and C once, in the scan's activation dtype, and its parameters in fp32;
the calls' (B, L, K·D, N = 16) as the reference records them) over the
card's HBM bytes/s, as a share of the device time of every kernel whose
name starts ``vmasr::``, the port's namespace: whatever kernel of the port
implements the scan is matched, the recurrence today, a fused N = 16 scan
tomorrow. Today's general-N route runs its exp, products and sums as torch
kernels around the recurrence: they lie outside the denominator here and
show in ``forward_busy_ms.classify``."""


def read(ctx):
    if ctx["kind"] != "classify" or not ctx["peaks"]:
        return None
    from benchmark.trace import short_name

    us = sum(e - s for name, s, e in ctx["device"] if short_name(name).startswith("vmasr::"))
    if not us:
        return None
    return 100.0 * ctx["scan_bytes"] / ctx["peaks"]["hbm_bytes_per_s"] / (us * 1e-6)
