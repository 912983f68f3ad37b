"""The work of scoring one document with the Jamba language model: the
products' FLOPs and the scans' least bytes.

- FLOPs: every matrix product of the reference (``reference/jamba.py``),
  2 × its weight's size a token (each projection, and the tied head's
  hidden × vocabulary), and attention's q kᵀ and p v at their causal half:
  a query at position t meets t + 1 keys, so 2 products × 2 × heads ×
  head_dim × L(L + 1)/2 a layer. The depthwise convolution, the norms and
  the scan count nothing, as ``flops.py`` counts.
- Scan bytes: a call at (B, L, D, N) with K = 1 direction reads u and Δ
  and writes y (3 (B, L, D) passes), reads B and C (2 (B, L, 1, N)
  passes), in the scan's activation dtype, and A (D·N), D and Δ's bias
  (D each) in fp32, once each. ``scan_bytes.py`` fixes K = 4 for the
  SS2D's four directions and is not this count.
"""

from __future__ import annotations

import torch

from ..reference.generator import Linear
from ..reference.jamba import JambaLM, layer_kinds
from ..reference.precision import Products


def matrix_flops_per_token(cfg: dict) -> int:
    """2 × the weights of the reference's matrix products, the head's
    included: the FLOPs a token of every projection."""
    with torch.device("meta"):
        model = JambaLM(cfg, Products("fp32"))
    weights = sum(m.weight.numel() for m in model.modules() if isinstance(m, Linear))
    return 2 * (weights + model.embed_tokens.weight.numel())


def attention_flops(cfg: dict, tokens: int) -> int:
    """q kᵀ and p v of every attention layer over a document of ``tokens``,
    at their causal half."""
    j = cfg["MODEL"]["JAMBA"]
    layers = layer_kinds(j).count("attention")
    return layers * 2 * 2 * j["HIDDEN_SIZE"] * tokens * (tokens + 1) // 2


def doc_flops(cfg: dict, tokens: int, per_token: int) -> int:
    """The products' FLOPs of one document of ``tokens``, given
    ``matrix_flops_per_token(cfg)``."""
    return tokens * per_token + attention_flops(cfg, tokens)


def scan_call_bytes(batch: int, length: int, d: int, n: int, itemsize: int = 2) -> int:
    """Least bytes of one K = 1 scan call at (B, L, D, N)."""
    return (3 * batch * length * d + 2 * batch * length * n) * itemsize + (d * n + 2 * d) * 4


def doc_scan_bytes(cfg: dict, length: int, itemsize: int) -> int:
    """Least bytes of the scan calls of one forward over ``length``
    positions, one call a Mamba layer."""
    j = cfg["MODEL"]["JAMBA"]
    calls = layer_kinds(j).count("mamba")
    return calls * scan_call_bytes(1, length, j["MAMBA_EXPAND"] * j["HIDDEN_SIZE"],
                                   j["MAMBA_D_STATE"], itemsize)
