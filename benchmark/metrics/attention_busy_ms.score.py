"""Device ms a request of the attention kernels that torch's
``scaled_dot_product_attention`` launches for the two attention layers,
matched by the names the trace gives them: FlashAttention's
(``pytorch_flash::flash_fwd_kernel``), the memory-efficient kernels'
(``fmha_cutlass…``) and cuDNN's (``…sdpa…``), whichever backend torch
picks; over the profiled requests' count."""

SDPA_KERNELS = ("flash_fwd", "fmha_cutlass", "sdpa")


def read(ctx):
    if ctx["kind"] != "score" or not ctx["units"]:
        return None
    from benchmark.trace import matching_us

    us = matching_us(ctx["device"], SDPA_KERNELS)
    if not us:
        return None
    return us / ctx["units"] / 1e3
