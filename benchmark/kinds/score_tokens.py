"""Document scoring traffic: one client sends documents of token ids to
``Scorer.score``, one after another (a closed loop), and takes back each
next token's log-probability.

The mix (``traffic/<mix>.json``) gives the pool's size and its length
distribution (its quantiles, clipped, the same for every seed), how many
finished requests the check compares and at how many positions, and how
many requests the profiler covers. The seed draws the token ids, uniform
over the vocabulary, and the order in which the client sends the pool's
documents. A request is timed from the call to its return, with the
log-probabilities on the host; a request that raises counts as failed and
as lasting the whole window.

The program comes from the configuration through the port's factory
(``models.build_language_model``) and serves through
``train/scorer.py``; a program without them fails at set-up. Its weights
are seeded (``weights_jamba.make_state``), kept on the host for the check.
Set-up scores one document of every bucket the pool holds twice: the
eager forward, then the capture of its graph.

Three readings decide ``correct``: ``logprob_gap``, the served
log-probabilities against the fp32 reference's; ``state_gap``, each scan
call of the program's forward against the reference's scan on the call's
own inputs; ``attn_gap``, each attention layer's output against the
reference's attention on the layer's own input.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from .. import compare
from ..counters import lm_work
from ..program_spans import recorded
from ..reference import jamba as ref_jamba
from ..reference import scan as ref_scan
from ..reference.generator import Env
from ..reference.precision import Products, set_plain_float32
from ..trace import profiled, sync
from ..weights_jamba import make_state


def doc_lengths(mix: dict) -> List[int]:
    """The pool's lengths in tokens: the quantiles (i + ½)/pool of the mix's
    log-normal, rounded and clipped, the same for every seed."""
    from scipy.stats import norm

    spec = mix["length"]
    q = (np.arange(mix["pool"]) + 0.5) / mix["pool"]
    tokens = spec["median_tokens"] * np.exp(spec["sigma"] * norm.ppf(q))
    return [int(v) for v in np.clip(np.rint(tokens), spec["min_tokens"], spec["max_tokens"])]


def check_positions(length: int, count: int, rng: random.Random) -> List[int]:
    """The positions of a document the check compares: the first, the last
    and seeded others, ``count`` in all (fewer where it is shorter)."""
    inner = list(range(1, length - 1))
    return sorted({0, length - 1} | set(rng.sample(inner, max(0, min(count - 2, len(inner))))))


class Job:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        cfg = run.cfg
        self.compute = getattr(torch, cfg.DTYPE.COMPUTE) if cfg.AMP_ENABLE else torch.float32

    def bucket_of(self, tokens: int) -> int:
        return -(-tokens // self.bucket) * self.bucket

    # -- set-up -----------------------------------------------------------
    def setup(self):
        run, dev = self.run, self.run.device
        from vm_asr_tpu_torch.models import build_language_model
        from vm_asr_tpu_torch.train.scorer import BUCKET_TOKENS, Scorer

        self.bucket = BUCKET_TOKENS
        lengths = doc_lengths(self.mix)
        gen = torch.Generator(device=dev).manual_seed(run.seed % 2**63)
        ids = torch.randint(run.cfg.MODEL.JAMBA.VOCAB_SIZE, (sum(lengths),), generator=gen,
                            device=dev)
        self.pool = list(ids.cpu().split(lengths))
        run.mark("documents")
        with torch.device("meta"):
            ref = ref_jamba.JambaLM(run.cfg_dict, Products())
        self.state = make_state(ref, run.seed, dev, getattr(torch, run.cfg.DTYPE.PARAMS))
        run.mark("weights")
        self.model = build_language_model(run.cfg, dev, seed=run.seed)
        self.model.load_state_dict(self.state)
        self.scorer = Scorer(run.cfg, self.model, device=dev)
        run.mark("program")
        if run.fault is not None:
            run.fault(self)
        self.rng = np.random.default_rng(run.seed)
        first = {}
        for i, n in enumerate(lengths):
            first.setdefault(self.bucket_of(n), i)
        for i in first.values():  # every bucket's shape, eager and then captured
            for _ in range(2):
                self.request(i)
        sync(dev)
        run.mark("warm-up")

    def order(self):
        """The client's requests: seeded permutations of the pool."""
        while True:
            yield from (int(i) for i in self.rng.permutation(len(self.pool)))

    def request(self, i: int):
        return self.scorer.score(self.pool[i])

    # -- the measured window ---------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        keep = self.mix["check_requests"]
        pick = random.Random(self.run.seed)
        self.sample: List[tuple] = []
        lat, failed, done = [], 0, []
        order = self.order()
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            i = next(order)
            ts = time.perf_counter()
            try:
                with self.run.spans.span("request"):
                    out = self.request(i)
            except Exception:  # a failed request: counted, and the client goes on
                traceback.print_exc()
                failed += 1
                end = time.perf_counter()
                continue
            end = time.perf_counter()
            lat.append(end - ts)
            done.append(i)
            kept = (i, out.logprobs.clone(),
                    check_positions(len(self.pool[i]), self.mix["check_positions"], pick))
            if len(self.sample) < keep:
                self.sample.append(kept)
            elif pick.random() < keep / len(done):
                self.sample[pick.randrange(keep)] = kept
        window_s = end - t0
        lat += [window_s] * failed
        self.done, self.window_s = done, window_s
        return {"serve_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else 0.0,
                "attempted": len(done) + failed, "failed": failed}

    # -- the traced run ---------------------------------------------------
    def traced(self) -> dict:
        """Per-layer readings from a profiled replay of the measured
        window's first ``profile_requests`` requests."""
        run, spans, cfg = self.run, self.run.spans, self.run.cfg_dict
        per_token = lm_work.matrix_flops_per_token(cfg)
        itemsize = torch.empty((), dtype=self.compute).element_size()
        n = min(self.mix["profile_requests"], len(self.done))

        def body():
            for i in self.done[:n]:
                with spans.span("request"):
                    self.request(i)

        ctx = {
            **profiled(spans, run.device, body),
            "kind": "score", "peaks": run.peaks, "measured_s": self.window_s,
            "flops": sum(lm_work.doc_flops(cfg, len(self.pool[i]), per_token) for i in self.done),
            "units": n,
            "scan_bytes": sum(lm_work.doc_scan_bytes(cfg, self.bucket_of(len(self.pool[i])),
                                                     itemsize) for i in self.done[:n]),
        }
        replays = [s.counts.get("graph_replays") for s in recorded() or () if s.name == "lm"]
        print(f"lm spans' graph_replays: {replays}", file=sys.stderr)
        return ctx

    def trace_hooks(self):
        """No harness spans beyond the request: the program's own spans
        split it (``Scorer.score``)."""

    # -- the check --------------------------------------------------------
    def release(self):
        del self.scorer
        sync(self.run.device)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, products: Products) -> Dict[int, torch.Tensor]:
        """The reference's log-probabilities of each checked request, with
        its products at ``products``' precision, by position in the sample."""
        set_plain_float32()
        dev = self.run.device
        with torch.device("meta"):
            ref = ref_jamba.JambaLM(self.run.cfg_dict, products)
        ref = ref.to_empty(device=dev)
        ref.load_state_dict(self.state)
        out = {k: ref_jamba.logprobs(ref.eval(), self.pool[i].to(dev)).cpu()
               for k, (i, _, _) in enumerate(self.sample)}
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def program_readings(self) -> Dict[int, torch.Tensor]:
        return {k: lp for k, (_, lp, _) in enumerate(self.sample)}

    def readings_against(self, ref: Dict[int, torch.Tensor], side: Dict[int, torch.Tensor]
                         ) -> Dict[str, float]:
        """``logprob_gap``: the largest |side − reference| over every
        log-probability of the checked requests, over the largest
        |reference − its mean| there."""
        gap = max(float((side[k].double() - ref[k].double()).abs().max()) for k in ref)
        scale = max(float((ref[k].double() - ref[k].double().mean()).abs().max()) for k in ref)
        return {"logprob_gap": gap / max(scale, 1e-30)}

    def route_gaps(self, scan_sides=("program",), attn_sides=("program",)) -> Dict[str, dict]:
        """``state_gap`` and ``attn_gap`` of each side, read in one eager
        forward of the served model over each sampled request's padded
        bucket, the shapes its graph replays, at the request's checked
        positions:

        - ``state_gap``: over every scan call, the largest |y_side − y_ref|
          over the largest |y_ref − D·u|, the states' part of y; y_ref is
          the fp32 reference scan (``reference/scan.py``) on the call's own
          inputs. Sides: ``program`` (the route's y), ``fp32``/``bf16``/
          ``fp8`` (the reference scan with u, Δ, B and C rounded as
          ``Products`` rounds a product's operands), ``fault_state`` (the
          reference scan with its last state channel's C zeroed).
        - ``attn_gap``: over every attention layer, the largest
          |out_side − out_ref| over the largest |out_ref|, out_ref the
          reference's attention (its weights from the seeded state) on the
          layer's own input. Sides: ``program`` (the layer's output),
          ``fp32``/``bf16``/``fp8`` (the reference at that precision)."""
        from vm_asr_tpu_torch.models import jamba
        from vm_asr_tpu_torch.train.scorer import Scorer

        set_plain_float32()
        dev = self.run.device
        program = Scorer(self.run.cfg, self.model, device=dev)
        route = jamba.selective_scan
        gaps = {"state_gap": dict.fromkeys(scan_sides, 0.0),
                "attn_gap": dict.fromkeys(attn_sides, 0.0)}
        shares: List[float] = []
        pos = None

        def read(u, dts, a_neg, bs, cs, ds, dt_bias, *args, **kwargs):
            y = route(u, dts, a_neg, bs, cs, ds, dt_bias, *args, **kwargs)
            u_, dts_, bs_, cs_ = (t.float() for t in (u, dts, bs, cs))
            a_, ds_, bias_ = a_neg.float(), ds.float(), dt_bias.float()
            want = ref_scan.selective_scan(u_, dts_, a_, bs_, cs_, ds_, bias_)[:, pos]
            states = want - ds_[None, None] * u_[:, pos]
            scale = float(states.abs().max())
            shares.append(scale / max(float(want.abs().max()), 1e-30))
            for side in scan_sides:
                if side == "program":
                    got = y[:, pos].float()
                elif side == "fault_state":
                    cut = cs_.clone()
                    cut[..., -1] = 0
                    got = ref_scan.selective_scan(u_, dts_, a_, bs_, cut, ds_, bias_)[:, pos]
                else:
                    q = Products(side).q
                    got = ref_scan.selective_scan(q(u_), q(dts_), a_, q(bs_), q(cs_), ds_,
                                                  bias_)[:, pos]
                gap = float((got - want).abs().max()) / max(scale, 1e-30)
                gaps["state_gap"][side] = max(gaps["state_gap"][side], gap)
            return y

        j = self.run.cfg_dict["MODEL"]["JAMBA"]
        env = Env(Products("fp32"))
        hooks = []
        for li, layer in enumerate(self.model.layers):
            if layer.kind != "attention":
                continue
            ref = ref_jamba.Attention(env, j).to(dev)
            prefix = f"layers.{li}.self_attn."
            ref.load_state_dict({k[len(prefix):]: v for k, v in self.state.items()
                                 if k.startswith(prefix)})

            def hook(module, args, out, ref=ref):
                x = args[0].float()
                env.products = Products("fp32")
                want = ref(x, pos)
                scale = float(want.abs().max())
                for side in attn_sides:
                    if side == "program":
                        got = out[:, pos].float()
                    else:
                        env.products = Products(side)
                        got = ref(x, pos)
                    gap = float((got - want).abs().max()) / max(scale, 1e-30)
                    gaps["attn_gap"][side] = max(gaps["attn_gap"][side], gap)

            hooks.append(layer.self_attn.register_forward_hook(hook))
        jamba.selective_scan = read
        try:
            for i, _, checked in self.sample:
                pos = torch.as_tensor(checked, device=dev)
                with torch.inference_mode():
                    program.model(program.load_input(self.pool[i]))
        finally:
            jamba.selective_scan = route
            for h in hooks:
                h.remove()
        if shares:
            print(f"states' part of y at the checked positions: {min(shares):.4f}-"
                  f"{max(shares):.4f} of max|y| over {len(shares)} scan calls", file=sys.stderr)
        return gaps

    def check(self) -> Dict[str, dict]:
        """Each sampled request's log-probabilities against the fp32
        reference's of the same document, and its forward's scan calls and
        attention layers against the reference's (``route_gaps``)."""
        ref = self.reference_readings(Products("fp32"))
        values = self.readings_against(ref, self.program_readings())
        gaps = self.route_gaps()
        values["state_gap"] = gaps["state_gap"]["program"]
        values["attn_gap"] = gaps["attn_gap"]["program"]
        return compare.checked(values, self.run.limits["limits"])
