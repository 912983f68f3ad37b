"""The whole forward's share of the card's dense bf16 peak: the products'
FLOPs of every image the traced run's measured window classified (counted
on the reference at one image's shape, ``counters/image_work.py``) over
that window's seconds."""


def read(ctx):
    if ctx["kind"] != "classify" or not ctx["peaks"] or not ctx["measured_s"]:
        return None
    return 100.0 * ctx["flops"] / ctx["measured_s"] / ctx["peaks"]["bf16_flops"]
