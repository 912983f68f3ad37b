"""Plain reference of the Jamba language model (Lieber et al., "Jamba: A
Hybrid Transformer-Mamba Language Model", arXiv:2403.19887; AI21-Jamba2-3B,
huggingface.co/ai21labs/AI21-Jamba2-3B config.json), in float32 plain
torch, in the equations of the transformers library's ``JambaMambaMixer``,
``JambaAttention``, ``JambaMLP`` and ``JambaRMSNorm``:

    x = embed(ids)
    layer i (attention where i % attn_layer_period == attn_layer_offset,
    else Mamba):  h = x + mixer(rms_in(x));  x = h + mlp(rms_ff(h))
    log p(ids[t+1] | ids[≤t]) = log_softmax(rms_final(x_t) · embedᵀ)[ids[t+1]]

- Mamba mixer: (u, z) = in_proj(x); u = silu(causal depthwise conv of
  d_conv taps (u) + b); (r, B, C) = x_proj(u), each through its RMSNorm;
  Δ = dt_proj.weight · r; y = the selective scan with dt = softplus(Δ +
  dt_proj.bias), A = −exp(A_log), the D skip; out_proj(y · silu(z)).
- Attention: q, k, v projections with num_key_value_heads shared heads,
  softmax(q kᵀ / √head_dim) v under the causal mask, o_proj.
- MLP: down(silu(gate(x)) · up(x)). RMSNorm: w · x / √(mean(x²) + eps).

Products (linear, and attention's q kᵀ and p v) at the precision of
``Products``; the scan is ``reference/scan.py``'s doubling scan, which
records each call's (B, L, K·D, N) in ``Env.scan_record`` (K = 1 here, so
K·D = d_inner). The parameter names are the program's
(``vm_asr_tpu_torch/models/jamba.py``, the published checkpoint's without
its ``model.`` prefix), so that one state dict serves both. It imports
nothing of the program and nothing of JAX.

Departures from the published description:

- Attention runs over blocks of query rows and the head's log-softmax over
  blocks of rows, so that a 16 k-token document fits: the same sums.
- The causal convolution is written as a sum of its taps' shifted
  products, elementwise and outside ``Products``, as a depthwise
  convolution counts no matrix product.
- The scan's arithmetic is float32, as the published kernel path's
  (``selective_scan_fn``) is; the rest is float32 too, where the published
  model runs in bfloat16.
- Evaluation only: no dropout (the published attention_dropout is 0) and
  no cache; the embedding's padding row is an ordinary row of the lookup.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .generator import Env, Linear
from .precision import Products, set_plain_float32
from .scan import selective_scan

# Query rows of attention and rows of the head's logits a block.
ATTN_ROWS = 512
HEAD_ROWS = 1024


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))


class CausalConv1d(nn.Module):
    """y_t = b + Σ_j w_j · u_{t − (taps − 1) + j}, u_{<0} = 0, per channel;
    (B, L, C) → (B, L, C)."""

    def __init__(self, channels: int, taps: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, taps))
        self.bias = nn.Parameter(torch.empty(channels)) if bias else None

    def forward(self, u):
        taps, l = self.weight.shape[-1], u.shape[1]
        up = F.pad(u, (0, 0, taps - 1, 0))
        y = sum(self.weight[:, 0, j] * up[:, j:j + l] for j in range(taps))
        return y if self.bias is None else y + self.bias


class MambaMixer(nn.Module):
    def __init__(self, env: Env, j: dict):
        super().__init__()
        hidden, n, rank = j["HIDDEN_SIZE"], j["MAMBA_D_STATE"], j["MAMBA_DT_RANK"]
        d = j["MAMBA_EXPAND"] * hidden
        self.env, self.n, self.rank = env, n, rank
        self.in_proj = Linear(env, hidden, 2 * d, bias=j["MAMBA_PROJ_BIAS"])
        self.conv1d = CausalConv1d(d, j["MAMBA_D_CONV"], j["MAMBA_CONV_BIAS"])
        self.x_proj = Linear(env, d, rank + 2 * n, bias=False)
        self.dt_proj = Linear(env, rank, d, bias=True)
        self.A_log = nn.Parameter(torch.empty(d, n))
        self.D = nn.Parameter(torch.empty(d))
        self.out_proj = Linear(env, d, hidden, bias=j["MAMBA_PROJ_BIAS"])
        eps = j["RMS_NORM_EPS"]
        self.dt_layernorm = RMSNorm(rank, eps)
        self.b_layernorm = RMSNorm(n, eps)
        self.c_layernorm = RMSNorm(n, eps)

    def forward(self, x):
        u, z = self.in_proj(x).chunk(2, dim=-1)
        u = F.silu(self.conv1d(u))
        r, bs, cs = self.x_proj(u).split([self.rank, self.n, self.n], dim=-1)
        dts = self.env.products.linear(self.dt_layernorm(r), self.dt_proj.weight)
        y = selective_scan(u[:, :, None], dts[:, :, None], -torch.exp(self.A_log)[None],
                           self.b_layernorm(bs)[:, :, None], self.c_layernorm(cs)[:, :, None],
                           self.D[None], self.dt_proj.bias[None], record=self.env.scan_record)
        return self.out_proj(y[:, :, 0] * F.silu(z))


class Attention(nn.Module):
    def __init__(self, env: Env, j: dict):
        super().__init__()
        hidden, self.heads, self.kv = (j["HIDDEN_SIZE"], j["NUM_ATTENTION_HEADS"],
                                       j["NUM_KEY_VALUE_HEADS"])
        self.env, self.hd = env, hidden // self.heads
        self.q_proj = Linear(env, hidden, self.heads * self.hd, bias=False)
        self.k_proj = Linear(env, hidden, self.kv * self.hd, bias=False)
        self.v_proj = Linear(env, hidden, self.kv * self.hd, bias=False)
        self.o_proj = Linear(env, self.heads * self.hd, hidden, bias=False)

    def forward(self, x, rows: Optional[torch.Tensor] = None):
        """The output at the query positions ``rows`` (default every one),
        (B, L, hidden) → (B, len(rows), hidden); each row sees the keys at
        its position and before."""
        b, l, _ = x.shape
        p = self.env.products
        rows = torch.arange(l, device=x.device) if rows is None else rows
        g = self.heads // self.kv
        top = int(rows.max()) + 1
        k = self.k_proj(x[:, :top]).view(b, top, self.kv, self.hd).transpose(1, 2)
        v = self.v_proj(x[:, :top]).view(b, top, self.kv, self.hd).transpose(1, 2)
        out = []
        for idx in rows.split(ATTN_ROWS):
            n, span = idx.numel(), int(idx.max()) + 1
            q = self.q_proj(x[:, idx]).view(b, n, self.kv, g, self.hd).permute(0, 2, 3, 1, 4)
            s = p.einsum("bgrqd,bgkd->bgrqk", q, k[:, :, :span]) * self.hd ** -0.5
            mask = torch.arange(span, device=x.device)[None, :] > idx[:, None]
            w = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
            o = p.einsum("bgrqk,bgkd->bgrqd", w, v[:, :, :span])
            out.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, self.heads * self.hd))
        return self.o_proj(torch.cat(out, dim=1))


class MLP(nn.Module):
    def __init__(self, env: Env, j: dict):
        super().__init__()
        hidden, width = j["HIDDEN_SIZE"], j["INTERMEDIATE_SIZE"]
        self.gate_proj = Linear(env, hidden, width, bias=False)
        self.up_proj = Linear(env, hidden, width, bias=False)
        self.down_proj = Linear(env, width, hidden, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Layer(nn.Module):
    def __init__(self, env: Env, j: dict, kind: str):
        super().__init__()
        self.kind = kind
        self.input_layernorm = RMSNorm(j["HIDDEN_SIZE"], j["RMS_NORM_EPS"])
        if kind == "attention":
            self.self_attn = Attention(env, j)
        else:
            self.mamba = MambaMixer(env, j)
        self.pre_ff_layernorm = RMSNorm(j["HIDDEN_SIZE"], j["RMS_NORM_EPS"])
        self.feed_forward = MLP(env, j)

    def forward(self, x):
        mixer = self.self_attn if self.kind == "attention" else self.mamba
        h = x + mixer(self.input_layernorm(x))
        return h + self.feed_forward(self.pre_ff_layernorm(h))


def layer_kinds(j: dict) -> List[str]:
    period, offset = j["ATTN_LAYER_PERIOD"], j["ATTN_LAYER_OFFSET"]
    return ["attention" if i % period == offset else "mamba"
            for i in range(j["NUM_HIDDEN_LAYERS"])]


class JambaLM(nn.Module):
    """The language model of a configuration (the program's configuration
    dict, MODEL.TYPE "jamba", its MODEL.JAMBA keys)."""

    def __init__(self, cfg: dict, products: Products):
        super().__init__()
        j = cfg["MODEL"]["JAMBA"]
        if cfg["MODEL"]["TYPE"] != "jamba" or not j["TIE_WORD_EMBEDDINGS"]:
            raise NotImplementedError(f"the reference covers Jamba with tied embeddings, "
                                      f"not {cfg['MODEL']}")
        self.env = Env(products)
        self.embed_tokens = Embedding(j["VOCAB_SIZE"], j["HIDDEN_SIZE"])
        self.layers = nn.ModuleList(Layer(self.env, j, kind) for kind in layer_kinds(j))
        self.final_layernorm = RMSNorm(j["HIDDEN_SIZE"], j["RMS_NORM_EPS"])

    def hidden(self, ids):
        x = self.embed_tokens.weight[ids]
        for layer in self.layers:
            x = layer(x)
        return self.final_layernorm(x)

    def forward(self, ids):
        """(B, L) token ids → (B, L − 1) log p(ids[:, t+1] | ids[:, ≤t])."""
        h = self.hidden(ids)[:, :-1]
        b, t = h.shape[:2]
        h, targets = h.reshape(b * t, -1), ids[:, 1:].reshape(-1, 1)
        out = [torch.log_softmax(self.env.products.linear(h[i:i + HEAD_ROWS],
                                                          self.embed_tokens.weight), dim=-1)
               .gather(-1, targets[i:i + HEAD_ROWS])[:, 0] for i in range(0, b * t, HEAD_ROWS)]
        return torch.cat(out).reshape(b, t)


@torch.no_grad()
def logprobs(model: JambaLM, ids: torch.Tensor) -> torch.Tensor:
    """``model``'s next-token log-probabilities of one document, (L,) ids →
    (L − 1,), with TF32 off for the card's float32 products."""
    set_plain_float32()
    return model(ids[None])[0]
