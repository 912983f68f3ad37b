"""The selective scan's share of its HBM roofline in the language model:
the least bytes of every scan call of the profiled requests (one call a
Mamba layer at K = 1 over the padded bucket: u, Δ and y once, B and C
once, in the scan's activation dtype, and its parameters in fp32;
``counters/lm_work.py``) over the card's HBM bytes/s, as a share of the
device time of every kernel whose name starts ``vmasr::``, the port's
namespace: the N-state kernel today, whatever kernel implements the scan
tomorrow."""


def read(ctx):
    if ctx["kind"] != "score" or not ctx["peaks"]:
        return None
    from benchmark.trace import short_name

    us = sum(e - s for name, s, e in ctx["device"] if short_name(name).startswith("vmasr::"))
    if not us:
        return None
    return 100.0 * ctx["scan_bytes"] / ctx["peaks"]["hbm_bytes_per_s"] / (us * 1e-6)
