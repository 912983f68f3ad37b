"""The whole forward's share of the card's dense bf16 peak: the products'
FLOPs of every document the traced run's measured window scored (its real
tokens, not the padding: ``counters/lm_work.py``, the reference's matrix
products a token and attention's at their causal half) over that
window's seconds."""


def read(ctx):
    if ctx["kind"] != "score" or not ctx["peaks"] or not ctx["measured_s"]:
        return None
    return 100.0 * ctx["flops"] / ctx["measured_s"] / ctx["peaks"]["bf16_flops"]
