"""The Jamba language model (Lieber et al., "Jamba: A Hybrid
Transformer-Mamba Language Model", arXiv:2403.19887; AI21-Jamba2-3B), a
stack of Mamba-1 mixers with an attention layer among every few, in the
equations of the transformers library's ``JambaMambaMixer``,
``JambaAttention``, ``JambaMLP`` and ``JambaRMSNorm``:

    x = embed(ids)
    per layer l:  h = x + mixer_l(rms_in(x));  x = h + mlp(rms_ff(h))
    logits = rms_final(x) @ embedᵀ                    (tied embeddings)
    mlp(x) = down(silu(gate(x)) * up(x))

Layer i is attention where i % period == offset, else Mamba. Mamba mixer:
(u, z) = in_proj(x); u = silu(causal depthwise conv(u) + b);
(r, B, C) = x_proj(u) split [dt_rank, N, N], each through its own RMSNorm;
Δ = dt_proj.weight · r; y = selective_scan(u, Δ, A = −exp(A_log), B, C, D,
dt_proj.bias, softplus) at K = 1 direction (``ops/scan_api.py``: at N = 16
without a gradient one launch of the N-state kernel); out_proj(y · silu(z)).
Attention: q, k, v projections with ``num_key_value_heads`` shared heads,
causal scaled dot-product attention at 1/√head_dim with no positional
encoding, o_proj.

``forward(ids)`` returns the log-probability of each next token,
log p(ids[:, t+1] | ids[:, ≤t]) in fp32, with the head's log-softmax taken
over blocks of at most ``HEAD_ROWS`` rows, so that a long document's
(L, vocabulary) logits are never whole. The parameter names are the
published checkpoint's without its ``model.`` prefix. Matrices take the
parameters' dtype (``cast_params``); ``A_log``, ``D`` and Δ's bias stay
fp32, as the scan takes them.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.scan_api import selective_scan
from .layers import Linear, uniform_

# Rows of the head's logits a block: (2048, 65536) fp32 is 0.5 GB.
HEAD_ROWS = 2048
# Parameters kept in fp32 whatever the matrices' dtype: the scan's own.
FP32_PARAMS = ("A_log", "D", "dt_proj.bias")


def layer_types(layers: int, period: int, offset: int) -> List[str]:
    """"attention" for layer i with i % period == offset, else "mamba"."""
    return ["attention" if i % period == offset else "mamba" for i in range(layers)]


class RMSNorm(nn.Module):
    """weight · x / √(mean(x²) + eps), the statistics in fp32, the result
    in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def init_from(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight.to(x.dtype) * y.to(x.dtype)


class Embedding(nn.Embedding):
    """The token embedding, N(0, 0.02²) as the published initialiser."""

    def init_from(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=0.02, generator=generator)


class CausalConv1d(nn.Module):
    """Depthwise convolution over L of ``taps`` taps that sees only the
    past: (B, L, C) → (B, L, C). torch's Conv1d parameters and init."""

    def __init__(self, channels: int, taps: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps))
        self.bias = nn.Parameter(torch.empty(channels)) if bias else None

    def init_from(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[-1])
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        taps, l = self.weight.shape[-1], x.shape[1]
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), bias, padding=taps - 1,
                     groups=x.shape[-1])
        return y[..., :l].transpose(1, 2)


class DtProj(Linear):
    """Δ's projection: its bias is the scan's dt_bias, initialised as
    Mamba's (softplus⁻¹ of dt log-uniform in [1e-3, 0.1], floored at 1e-4)
    and kept in fp32; the forward applies the weight alone."""

    def init_from(self, generator: torch.Generator) -> None:
        uniform_(self.weight, self.in_features ** -0.5, generator)
        lo, hi = math.log(1e-3), math.log(0.1)
        r = torch.rand(self.bias.shape, generator=generator, device=self.bias.device)
        dt = torch.exp(r * (hi - lo) + lo).clamp_min(1e-4)
        with torch.no_grad():
            self.bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class MambaMixer(nn.Module):
    """The Mamba-1 mixer of a Jamba layer, (B, L, hidden) → (B, L, hidden)."""

    def __init__(self, hidden: int, d_inner: int, d_state: int, d_conv: int, dt_rank: int,
                 conv_bias: bool, proj_bias: bool, eps: float, compute_dtype: torch.dtype):
        super().__init__()
        self.d_inner, self.d_state, self.dt_rank = d_inner, d_state, dt_rank
        lin = dict(compute_dtype=compute_dtype)
        self.in_proj = Linear(hidden, 2 * d_inner, bias=proj_bias, **lin)
        self.conv1d = CausalConv1d(d_inner, d_conv, conv_bias)
        self.x_proj = Linear(d_inner, dt_rank + 2 * d_state, bias=False, **lin)
        self.dt_proj = DtProj(dt_rank, d_inner, bias=True, **lin)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.empty(d_inner))
        self.out_proj = Linear(d_inner, hidden, bias=proj_bias, **lin)
        self.dt_layernorm = RMSNorm(dt_rank, eps)
        self.b_layernorm = RMSNorm(d_state, eps)
        self.c_layernorm = RMSNorm(d_state, eps)

    def init_from(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32,
                                                    device=self.A_log.device)).expand_as(self.A_log))
        nn.init.ones_(self.D)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u, z = self.in_proj(x).chunk(2, dim=-1)
        u = F.silu(self.conv1d(u))
        r, bs, cs = self.x_proj(u).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dts = self.dt_proj(self.dt_layernorm(r))
        y = selective_scan(u[:, :, None], dts[:, :, None], -torch.exp(self.A_log.float())[None],
                           self.b_layernorm(bs)[:, :, None], self.c_layernorm(cs)[:, :, None],
                           self.D.float()[None], self.dt_proj.bias.float()[None],
                           delta_softplus=True)
        return self.out_proj(y[:, :, 0] * F.silu(z))


class Attention(nn.Module):
    """Causal multi-head attention with ``kv_heads`` shared key and value
    heads and no positional encoding, (B, L, hidden) → (B, L, hidden)."""

    def __init__(self, hidden: int, heads: int, kv_heads: int, compute_dtype: torch.dtype):
        super().__init__()
        if hidden % heads or heads % kv_heads:
            raise ValueError(f"hidden {hidden}, heads {heads}, KV heads {kv_heads}: the heads "
                             "must divide hidden and the KV heads the heads")
        self.heads, self.kv_heads, self.head_dim = heads, kv_heads, hidden // heads
        lin = dict(bias=False, compute_dtype=compute_dtype)
        self.q_proj = Linear(hidden, heads * self.head_dim, **lin)
        self.k_proj = Linear(hidden, kv_heads * self.head_dim, **lin)
        self.v_proj = Linear(hidden, kv_heads * self.head_dim, **lin)
        self.o_proj = Linear(heads * self.head_dim, hidden, **lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape

        def heads(t, n):
            return t.view(b, l, n, self.head_dim).transpose(1, 2)

        o = causal_attention(heads(self.q_proj(x), self.heads),
                             heads(self.k_proj(x), self.kv_heads),
                             heads(self.v_proj(x), self.kv_heads))
        return self.o_proj(o.transpose(1, 2).reshape(b, l, self.heads * self.head_dim))


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √head_dim, causal) v, q (B, H, L, hd) over k and v of
    (B, H_kv, L, hd): torch's fused attention."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=q.shape[-1] ** -0.5,
                                          enable_gqa=k.shape[1] != q.shape[1])


class MLP(nn.Module):
    def __init__(self, hidden: int, width: int, compute_dtype: torch.dtype):
        super().__init__()
        lin = dict(bias=False, compute_dtype=compute_dtype)
        self.gate_proj = Linear(hidden, width, **lin)
        self.up_proj = Linear(hidden, width, **lin)
        self.down_proj = Linear(width, hidden, **lin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    """h = x + mixer(rms_in(x)); h + mlp(rms_ff(h)). The mixer is
    ``self_attn`` or ``mamba``, as the checkpoint names it."""

    def __init__(self, kind: str, hidden: int, eps: float, mixer: nn.Module, mlp: nn.Module):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(hidden, eps)
        setattr(self, "self_attn" if kind == "attention" else "mamba", mixer)
        self.pre_ff_layernorm = RMSNorm(hidden, eps)
        self.feed_forward = mlp

    @property
    def mixer(self) -> nn.Module:
        return self.self_attn if self.kind == "attention" else self.mamba

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x + self.mixer(self.input_layernorm(x))
        return h + self.feed_forward(self.pre_ff_layernorm(h))


def token_logprobs(hidden: torch.Tensor, weight: torch.Tensor, targets: torch.Tensor,
                   rows: int = HEAD_ROWS) -> torch.Tensor:
    """log softmax(hidden · weightᵀ)[target] of each row, (B, T, H) and
    (B, T) → (B, T) fp32, ``rows`` rows of logits at a time: each block's
    logits in the hidden's dtype, their log-sum-exp in fp32."""
    h = hidden.reshape(-1, hidden.shape[-1])
    t = targets.reshape(-1, 1)
    w = weight.to(h.dtype)
    out = []
    for i in range(0, h.shape[0], rows):
        logits = F.linear(h[i:i + rows], w).float()
        out.append(logits.gather(-1, t[i:i + rows])[:, 0] - torch.logsumexp(logits, dim=-1))
    return torch.cat(out).reshape(targets.shape)


class JambaLM(nn.Module):
    """The Jamba causal language model with tied embeddings."""

    def __init__(self, vocab_size: int = 65536, hidden_size: int = 2560,
                 num_hidden_layers: int = 28, num_attention_heads: int = 20,
                 num_key_value_heads: int = 1, intermediate_size: int = 8192,
                 attn_layer_period: int = 14, attn_layer_offset: int = 7,
                 mamba_d_state: int = 16, mamba_d_conv: int = 4, mamba_expand: int = 2,
                 mamba_dt_rank: int = 160, mamba_conv_bias: bool = True,
                 mamba_proj_bias: bool = False, rms_norm_eps: float = 1e-6, *,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed_tokens = Embedding(vocab_size, hidden_size)

        def mixer(kind):
            if kind == "attention":
                return Attention(hidden_size, num_attention_heads, num_key_value_heads,
                                 compute_dtype)
            return MambaMixer(hidden_size, mamba_expand * hidden_size, mamba_d_state,
                              mamba_d_conv, mamba_dt_rank, mamba_conv_bias, mamba_proj_bias,
                              rms_norm_eps, compute_dtype)

        self.layers = nn.ModuleList(
            DecoderLayer(kind, hidden_size, rms_norm_eps, mixer(kind),
                         MLP(hidden_size, intermediate_size, compute_dtype))
            for kind in layer_types(num_hidden_layers, attn_layer_period, attn_layer_offset))
        self.final_layernorm = RMSNorm(hidden_size, rms_norm_eps)

    def cast_params(self, dtype: torch.dtype) -> "JambaLM":
        """Every parameter in ``dtype`` but ``FP32_PARAMS``, which stay fp32."""
        for name, p in self.named_parameters():
            want = torch.float32 if name.endswith(FP32_PARAMS) else dtype
            p.data = p.data.to(want)
        return self

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids → the final RMSNorm's output (B, L, hidden)."""
        x = self.embed_tokens(ids).to(self.compute_dtype)
        for layer in self.layers:
            x = layer(x)
        return self.final_layernorm(x)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids → (B, L − 1) fp32 log p(ids[:, t+1] | ids[:, ≤t])."""
        h = self.hidden(ids)
        return token_logprobs(h[:, :-1], self.embed_tokens.weight, ids[:, 1:])
