"""The document-scoring cell on the CPU at a size a CPU holds (hidden 64,
four layers with attention at period 2 and offset 1, d_state 16,
vocabulary 256, documents of 64–200 tokens): a sound run is correct,
traced and not; each fault planted in the served program (the last state
channel dropped, attention without its causal mask, an attention layer's
output zeroed, a padded bucket whose padding reaches the real positions)
fails a reading; the fp8 control reads above the limits and the program
(bf16, as the configuration states) below them; ``counters/lm_work.py``
against counts written out by hand at the published widths; the
configuration file's published keys against the program's; and the
parent's tree, which lacks MODEL.JAMBA, fails at once."""

import functools
import json
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark.controls_score import readings
from benchmark.counters import lm_work
from benchmark.harness import BENCH, cell_spec, run_cell

CELL = "jamba2_3b.score_docs"
J = {"HIDDEN_SIZE": 64, "NUM_HIDDEN_LAYERS": 4, "NUM_ATTENTION_HEADS": 4, "INTERMEDIATE_SIZE": 128,
     "VOCAB_SIZE": 256, "ATTN_LAYER_PERIOD": 2, "ATTN_LAYER_OFFSET": 1, "MAMBA_DT_RANK": 4}
MIX = {"pool": 4, "length": {"dist": "lognormal", "median_tokens": 120, "sigma": 0.4,
                             "min_tokens": 64, "max_tokens": 200},
       "check_positions": 8, "profile_requests": 1}
TINY = {"program": {"MODEL": {"JAMBA": J}}, "mix": MIX}
FP32 = {**TINY, "program": {**TINY["program"], "AMP_ENABLE": False,
                            "DTYPE": {"PARAMS": "float32"}}}
# The control's size: at hidden 64 and four layers the fp8 products move
# the log-probabilities by 3 % of their spread, below ``logprob_gap``'s
# limit, set at the published widths and depth (fp8 there 0.35–0.53);
# at hidden 256 and eight layers by 20 %.
CONTROL = {"program": {"MODEL": {"JAMBA": {
    **J, "HIDDEN_SIZE": 256, "NUM_HIDDEN_LAYERS": 8, "INTERMEDIATE_SIZE": 1024, "VOCAB_SIZE": 1024,
    "ATTN_LAYER_PERIOD": 4, "MAMBA_DT_RANK": 16}}},
    "mix": {**MIX, "length": {**MIX["length"], "median_tokens": 200, "min_tokens": 100,
                              "max_tokens": 400}}}
PUBLISHED = json.loads((BENCH / "configs" / "jamba2_3b.json").read_text())


def _run(fault=None, trace=False, overrides=FP32):
    return run_cell(CELL, 2**31 + 5, 1.0, trace, time.perf_counter(), device="cpu",
                    fault=fault, overrides=overrides)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run_is_correct(trace):
    r = _run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logprob_gap", "state_gap", "attn_gap"}
    if trace:  # on the CPU only the program's spans read: no device events
        assert set(r["metrics"]) == {"lm_idle_ms.score", "padded_token_share.score"}
        assert 0 < r["metrics"]["padded_token_share.score"]["value"] < 1
    else:
        assert set(r["metrics"]) == {"serve_p95_ms", "setup_s"}


def _state_dropped(job, monkeypatch):
    from vm_asr_tpu_torch.models import jamba

    def faulty(scan, u, dts, A, Bs, Cs, *args, **kwargs):
        Cs = Cs.clone()
        Cs[..., -1] = 0
        return scan(u, dts, A, Bs, Cs, *args, **kwargs)

    monkeypatch.setattr(jamba, "selective_scan", functools.partial(faulty, jamba.selective_scan))


def _unmasked(job, monkeypatch):
    from vm_asr_tpu_torch.models import jamba

    def attention(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=k.shape[1] != q.shape[1])

    monkeypatch.setattr(jamba, "causal_attention", attention)


def _attention_zeroed(job, monkeypatch):
    layer = next(layer for layer in job.model.layers if layer.kind == "attention")
    with torch.no_grad():
        layer.self_attn.o_proj.weight.zero_()


def _padding_first(job, monkeypatch):
    """The bucket's padding put before the document, the outputs rolled back
    so that each real position's log-probability is where the scorer reads
    it: the padding now reaches every real position."""
    scorer = job.scorer
    forward, score, real = scorer.forward, scorer.score, {}

    def scored(ids):
        real["n"] = len(ids)
        return score(ids)

    def shifted(x):
        pad = x.shape[1] - real["n"]
        return torch.roll(forward(torch.roll(x, pad, dims=1)), -pad, dims=1)

    scorer.score, scorer.forward = scored, shifted


@pytest.mark.parametrize("fault, reading", [
    (_state_dropped, "state_gap"), (_unmasked, "attn_gap"), (_attention_zeroed, "attn_gap"),
    (_padding_first, "logprob_gap")], ids=["last_state_dropped", "attention_unmasked",
                                           "attention_zeroed", "padding_first"])
def test_planted_fault_is_not_correct(monkeypatch, fault, reading):
    r = _run(lambda job: fault(job, monkeypatch))
    assert not r["correct"], r["checks"]
    c = r["checks"][reading]
    assert c["value"] > c["limit"], r["checks"]


def test_control_fails_the_limits():
    """At hidden 256 and eight layers (``CONTROL``): the program in bf16, as
    the configuration states, under every limit; the reference with fp8
    products above each; the dropped state channel above ``state_gap``'s."""
    r = readings(CELL, 2**31 + 9, 1.0, "cpu", CONTROL)
    limits = cell_spec(CELL)["limits"]["limits"]
    for name, limit in limits.items():
        assert r["program"][name] < limit < r["control"][name], (name, r)
    assert r["fault_state"]["state_gap"] > limits["state_gap"], r


def test_work_counts_by_hand():
    """At the published widths: 2 × the weights of every product a token
    (26 Mamba mixers' in, x, dt and out projections, 2 attention layers'
    q, k, v and o, 28 MLPs, the tied head), attention at its causal half,
    and one (1, 4096, 5120) scan call's least bytes at K = 1."""
    cfg = PUBLISHED["program"]
    mamba = 2560 * 10240 + 5120 * 192 + 160 * 5120 + 5120 * 2560
    attention = 2560 * 2560 + 2 * 2560 * 128 + 2560 * 2560
    mlp = 3 * 2560 * 8192
    assert lm_work.matrix_flops_per_token(cfg) == \
        2 * (26 * mamba + 2 * attention + 28 * mlp + 65536 * 2560) == 6_052_249_600
    # q kᵀ and p v of 20 heads of 128 at 2 layers: 4096 · 4097 / 2 pairs.
    assert lm_work.attention_flops(cfg, 4096) == 2 * 2 * 2 * 20 * 128 * 4096 * 4097 // 2
    assert lm_work.doc_flops(cfg, 4096, 6_052_249_600) == \
        4096 * 6_052_249_600 + lm_work.attention_flops(cfg, 4096)
    call = (3 * 4096 * 5120 + 2 * 4096 * 16) * 2 + (5120 * 16 + 2 * 5120) * 4
    assert lm_work.scan_call_bytes(1, 4096, 5120, 16, 2) == call == 126_459_904
    assert lm_work.doc_scan_bytes(cfg, 4096, 2) == 26 * call


def test_program_keys_are_the_published_ones():
    """The configuration file's top-level keys (the catalog's config.json)
    and the program's MODEL.JAMBA hold the same model."""
    j = PUBLISHED["program"]["MODEL"]["JAMBA"]
    for key in ("hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
                "intermediate_size", "vocab_size", "attn_layer_period", "attn_layer_offset",
                "mamba_d_state", "mamba_d_conv", "mamba_expand", "mamba_dt_rank",
                "mamba_conv_bias", "mamba_proj_bias", "rms_norm_eps", "tie_word_embeddings"):
        assert j[key.upper()] == PUBLISHED[key], key
    assert PUBLISHED["num_experts"] == 1 and PUBLISHED["reduced"] == []


def test_parent_without_the_keys_fails_at_once(monkeypatch):
    """A program whose configuration has no MODEL.JAMBA fails while the run
    reads its configuration, before any set-up."""
    from benchmark import harness
    from vm_asr_tpu_torch.core import config

    default = config.default_config

    def old_defaults():
        c = default()
        c.MODEL.pop("JAMBA")
        return c

    monkeypatch.setattr(config, "default_config", old_defaults)
    t = time.perf_counter()
    with pytest.raises(KeyError, match="JAMBA"):
        harness.run_cell(CELL, 1, 1.0, False, t, device="cpu", overrides=FP32)
    assert time.perf_counter() - t < 5
