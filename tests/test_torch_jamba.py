"""The Jamba language model as a configuration of the port (MODEL.TYPE
"jamba": ``models.build_language_model``, ``train.Scorer``), on the CPU at
a small size with every part of the published model (hidden 64, four
layers with attention at period 2 and offset 1, one KV head, d_state 16,
vocabulary 256, documents of 64–200 tokens): the port against the
benchmark's plain reference (``benchmark/reference/jamba.py``) in fp32 and
bf16; the layer pattern and the tied head; the scorer's padding and its
blocked log-softmax; the N-state route at K = 1 and its geometry at the
published width; and the published configuration's parameter count."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.reference import jamba as ref_jamba
from benchmark.reference import scan as ref_scan
from benchmark.reference.precision import Products
from vm_asr_tpu_torch.core import default_config
from vm_asr_tpu_torch.core.profiling import clear_spans, recorded_spans
from vm_asr_tpu_torch.models import JambaLM, build_language_model, language_model_kwargs
from vm_asr_tpu_torch.models.jamba import layer_types, token_logprobs
from vm_asr_tpu_torch.ops.scan_api import selective_scan
from vm_asr_tpu_torch.ops.selective_scan_nstate import nstate_tile_layout
from vm_asr_tpu_torch.train import Scorer
from vm_asr_tpu_torch.train.scorer import BUCKET_TOKENS

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "benchmark/configs/jamba2_3b.json").read_text())["program"]
SMALL = {"MODEL": {"JAMBA": {"HIDDEN_SIZE": 64, "NUM_HIDDEN_LAYERS": 4, "NUM_ATTENTION_HEADS": 4,
                             "INTERMEDIATE_SIZE": 128, "VOCAB_SIZE": 256, "ATTN_LAYER_PERIOD": 2,
                             "ATTN_LAYER_OFFSET": 1, "MAMBA_DT_RANK": 4}}}
# Gaps of the port's log-probabilities from the fp32 reference's, over the
# largest |reference − its mean|. fp32: the same maths summed in other
# orders (SDPA, the N-state route's loop against the doubling scan), read
# at 3.7e-7–2.4e-6 over seeds 0–3. bf16: every weight and activation
# rounded to 2^-9 of itself, read at 0.0019–0.0069 over seeds 0–3, where the
# reference's fp8 control reads 0.020–0.071; the bar is three times the
# largest reading.
BARS = {"float32": 1e-5, "bfloat16": 0.02}


def _config(dtype: str = "float32"):
    c = default_config()
    c.merge_from_dict(PUBLISHED)
    c.merge_from_dict(SMALL)
    c.AMP_ENABLE = dtype != "float32"
    c.DTYPE.PARAMS = dtype
    return c


def _ids(length: int, seed: int = 0) -> torch.Tensor:
    return torch.randint(256, (length,), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference(dtype, seed):
    """Seeded weights: ``Scorer.score`` of a 150-token document (padded to
    its 1024-token bucket) against the fp32 reference on the same state
    dict, within the dtype's bar."""
    config = _config(dtype)
    model = build_language_model(config, "cpu", seed=seed)
    ref = ref_jamba.JambaLM(config.to_dict(), Products("fp32"))
    ref.load_state_dict(model.state_dict())
    ids = _ids(150, seed)
    got = Scorer(config, model, device="cpu").score(ids)
    want = ref_jamba.logprobs(ref, ids)
    scale = float((want - want.mean()).abs().max())
    assert got.logprobs.shape == (149,) and got.logprobs.dtype == torch.float32
    assert float((got.logprobs - want).abs().max()) <= BARS[dtype] * scale
    assert got.total == pytest.approx(float(got.logprobs.double().sum()))


def test_layer_pattern_and_tied_head():
    """Attention at i % period == offset (the published model's layers 7
    and 21); the head is the embedding: no weight of its own, and the
    forward's log-probabilities are the log-softmax of the final hidden
    states against it."""
    assert [i for i, k in enumerate(layer_types(28, 14, 7)) if k == "attention"] == [7, 21]
    model = build_language_model(_config(), "cpu", seed=3)
    assert [layer.kind for layer in model.layers] == ["mamba", "attention", "mamba", "attention"]
    assert [hasattr(layer, "self_attn") for layer in model.layers] == [False, True, False, True]
    assert not any("head" in k for k in model.state_dict())
    ids = _ids(80, 3)[None]
    with torch.inference_mode():
        logits = model.hidden(ids)[:, :-1] @ model.embed_tokens.weight.T
        want = torch.log_softmax(logits, -1).gather(-1, ids[:, 1:, None])[..., 0]
        torch.testing.assert_close(model(ids), want, rtol=1e-5, atol=1e-5)
    untied = _config()
    untied.MODEL.JAMBA.TIE_WORD_EMBEDDINGS = False
    with pytest.raises(ValueError, match="tied embeddings"):
        language_model_kwargs(untied)


@pytest.mark.parametrize("length", [64, 200])
def test_padded_bucket_scores_equal_unpadded(length):
    """The scorer pads a document on the right to its bucket; its scores
    equal the model's on the unpadded document: no padded position
    reaches a real one (causal conv, scan and attention)."""
    config = _config()
    model = build_language_model(config, "cpu", seed=5)
    scorer = Scorer(config, model, device="cpu")
    ids = _ids(length, 5)
    assert scorer.load_input(ids).shape == (1, BUCKET_TOKENS)
    with torch.inference_mode():
        want = model(ids[None])[0]
    torch.testing.assert_close(scorer.score(ids).logprobs, want, rtol=1e-5, atol=1e-5)


def test_blocked_log_softmax_equals_the_whole():
    gen = torch.Generator().manual_seed(7)
    h = torch.randn(2, 37, 16, generator=gen)
    w = torch.randn(50, 16, generator=gen)
    t = torch.randint(50, (2, 37), generator=gen)
    whole = torch.log_softmax(h @ w.T, -1).gather(-1, t[..., None])[..., 0]
    for rows in (5, 37, 74, 2048):
        torch.testing.assert_close(token_logprobs(h, w, t, rows), whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_nstate_route_at_one_direction(impl):
    """The scan as the Mamba mixer calls it, (1, L, K = 1, D) with N = 16,
    on its plain route and on the kernel route (which runs the N-state
    wrapper's plain version on the CPU) against the reference's doubling
    scan; fp32, the same maths in another order."""
    gen = torch.Generator().manual_seed(11)
    l, d, n = 130, 48, 16
    u = torch.randn(1, l, 1, d, generator=gen)
    dts = 0.5 * torch.randn(1, l, 1, d, generator=gen)
    bs, cs = (torch.randn(1, l, 1, n, generator=gen) for _ in range(2))
    a = -torch.arange(1, n + 1.0).expand(1, d, n)
    ds, bias = torch.ones(1, d), 0.1 * torch.randn(1, d, generator=gen)
    with torch.inference_mode():
        got = selective_scan(u, dts, a, bs, cs, ds, bias, impl=impl)
    want = ref_scan.selective_scan(u, dts, a, bs, cs, ds, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_nstate_geometry_at_the_published_width():
    """One (1, L, 5120) bf16 call at K = 1: 16 lanes a chain (5120 chains ×
    8 < 2^16 threads), 8 channels a CTA, 128 threads."""
    tile = nstate_tile_layout(1, 5120, 1, 16, 2)
    assert (tile.lanes, tile.channels, tile.threads) == (16, 8, 128)


def test_published_parameter_count_and_dtypes():
    """The published configuration builds 3 029 337 472 parameters (on the
    meta device); the factory keeps A_log, D and Δ's bias in fp32 and every
    other parameter in DTYPE.PARAMS."""
    config = default_config()
    config.merge_from_dict(PUBLISHED)
    with torch.device("meta"):
        model = JambaLM(**language_model_kwargs(config))
    assert sum(p.numel() for p in model.parameters()) == 3_029_337_472
    small = build_language_model(_config("bfloat16"), "cpu")
    dtypes = {k: p.dtype for k, p in small.named_parameters()}
    fp32 = sorted(k for k, d in dtypes.items() if d == torch.float32)
    assert fp32 == sorted(f"layers.{i}.mamba.{n}" for i in (0, 2)
                          for n in ("A_log", "D", "dt_proj.bias"))
    assert all(d == torch.bfloat16 for k, d in dtypes.items() if k not in fp32)


def test_scorer_spans_and_checks():
    """Under a profiler a request records request > load, lm (tokens,
    bucket_tokens), save; ids outside the vocabulary or of another dtype
    raise before any work."""
    config = _config()
    scorer = Scorer(config, build_language_model(config, "cpu"), device="cpu")
    clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        scorer.score(_ids(100))
    spans = {s.name: s for s in recorded_spans()}
    clear_spans()
    assert set(spans) == {"request", "load", "lm", "save"}
    assert all(spans[n].parent == spans["request"].id for n in ("load", "lm", "save"))
    assert spans["lm"].counts == {"tokens": 100, "bucket_tokens": BUCKET_TOKENS}
    with pytest.raises(ValueError, match="token ids"):
        scorer.score(torch.tensor([1, 256]))
    with pytest.raises(ValueError, match="int64"):
        scorer.score(torch.tensor([1, 2], dtype=torch.int32))
