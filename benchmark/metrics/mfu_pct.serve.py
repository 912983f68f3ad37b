"""The whole forward's share of the card's dense bf16 peak: the products'
FLOPs of every segment the traced run's measured window served (counted on
the reference at one segment's shape, times the segments each clip needs)
over that window's seconds."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["peaks"] or not ctx["measured_s"]:
        return None
    return 100.0 * ctx["flops"] / ctx["measured_s"] / ctx["peaks"]["bf16_flops"]
