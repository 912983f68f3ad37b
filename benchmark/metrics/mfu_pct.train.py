"""The whole GAN step's share of the card's dense bf16 peak: the products'
FLOPs of a step (counted on the reference: the generator's forward and
gradient, the MPD on real and fake differentiated in the fake, and on each
alone differentiated in its weights) times the steps of the traced run's
measured window, over that window's seconds."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["peaks"] or not ctx["measured_s"]:
        return None
    return 100.0 * ctx["flops"] / ctx["measured_s"] / ctx["peaks"]["bf16_flops"]
