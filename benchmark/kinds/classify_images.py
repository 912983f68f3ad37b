"""Image classification traffic: one client sends batches of images to
``Classifier.classify``, one after another (a closed loop).

The mix (``traffic/<mix>.json``) gives the batch, the host pool's size in
batches, how many rows of how many finished requests the check compares,
and how many requests the profiler covers. The seed draws the images and
the order in which the client sends the pool's batches. A request is timed
from the call to its return, with the logits and the top-5 ids on the
host; a request that raises counts as failed and as lasting the whole
window.

The program comes from the configuration through the port's factory
(``models.build_classifier``) and serves through ``train/classifier.py``;
a program without them fails at set-up. Its weights are seeded
(``weights.make_state``) with each SS2D's B and C projections scaled by
``STATE_GAIN``, so that the recurrence's states carry a share of y that a
check can see.

Two readings decide ``correct`` beside the top-5: ``logit_gap``, the
served logits (the graph's replay) against the fp32 reference's, and
``state_gap``, the scan route itself against the reference's scan on the
route's own inputs.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import compare
from ..counters import image_work, scan_bytes
from ..program_spans import recorded
from ..reference import scan as ref_scan
from ..reference import vssm as ref_vssm
from ..reference.precision import Products, set_plain_float32
from ..trace import profiled, sync
from ..weights import make_state


# The B and C rows of each SS2D's x_proj, × this over the published
# initialisation's: there the states' part of y (C·h, quadratic in B and
# C) is 0.8–1.6 % of it at 224², under bf16's rounding of y, so that no
# fault of the recurrence can show; at 8 × it is 42–70 % (the reference at
# one seed). The rows' other uses are unchanged: Δ's rows keep their scale.
STATE_GAIN = 8.0


def with_state_gain(state: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """``state`` with the B and C rows (the last 2·``n``) of every
    ``x_proj_weight`` (K, dt_rank + 2N, D) × ``STATE_GAIN``."""
    out = dict(state)
    for key, w in state.items():
        if key.endswith("x_proj_weight"):
            w = w.clone()
            w[:, -2 * n:] *= STATE_GAIN
            out[key] = w
    return out


def synth_images(count: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """``count`` (size, size, 3) uint8 images: seeded smooth colour fields
    (an 8 × 8 grid of colours, bilinearly enlarged) with pixel noise, so
    that neighbouring pixels correlate as in a photograph."""
    coarse = torch.rand(count, 3, 8, 8, generator=gen, device=device)
    field = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    noise = torch.randn(count, 3, size, size, generator=gen, device=device)
    pixels = (field * 255 + 12 * noise).clamp(0, 255).round().to(torch.uint8)
    return pixels.permute(0, 2, 3, 1).contiguous()


def check_rows(batch: int, count: int, rng: random.Random) -> List[int]:
    """The rows of a request the check compares: the first, the last and
    seeded others, ``count`` in all (fewer where the batch is smaller)."""
    inner = list(range(1, batch - 1))
    rows = {0, batch - 1} | set(rng.sample(inner, max(0, min(count - 2, len(inner)))))
    return sorted(rows)


class Job:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.batch = int(self.mix["batch"])

    # -- set-up -----------------------------------------------------------
    def setup(self):
        run, dev = self.run, self.run.device
        from vm_asr_tpu_torch.models import build_classifier
        from vm_asr_tpu_torch.train.classifier import Classifier

        size = run.cfg.DATA.IMG_SIZE
        gen = torch.Generator(device=dev).manual_seed(run.seed % 2**63)
        self.pool = [synth_images(self.batch, size, gen, dev).cpu()
                     for _ in range(self.mix["pool"])]
        run.mark("images")
        with torch.device("meta"):
            ref = ref_vssm.VSSM(run.cfg_dict, Products())
        self.state = with_state_gain(make_state(ref, run.seed, dev),
                                     run.cfg.MODEL.VSSM.SSM_D_STATE)
        self.model = build_classifier(run.cfg, dev, seed=run.seed)
        self.model.load_state_dict(self.state)
        self.classifier = Classifier(run.cfg, self.model, device=dev)
        run.mark("program")
        if run.fault is not None:
            run.fault(self)
        self.rng = np.random.default_rng(run.seed)
        # The one request shape, eager and then captured.
        for _ in range(2):
            self.request(0)
        sync(dev)
        run.mark("warm-up")

    def order(self):
        """The client's requests: seeded permutations of the pool."""
        while True:
            yield from (int(i) for i in self.rng.permutation(len(self.pool)))

    def request(self, i: int):
        return self.classifier.classify(self.pool[i])

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
            rows = check_rows(self.batch, self.mix["check_rows"], pick)
            kept = (i, rows, out.logits[rows].clone(), out.top5[rows].clone())
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
        run, spans = self.run, self.run.spans
        work = image_work.image_work(run.cfg_dict, self.batch)
        itemsize = scan_bytes.scan_itemsize(run.cfg_dict)
        request_bytes = scan_bytes.total_bytes(work["scan_calls"], itemsize, backward=False)
        n = min(self.mix["profile_requests"], len(self.done))

        def body():
            for i in self.done[:n]:
                with spans.span("request"):
                    self.request(i)

        ctx = {
            **profiled(spans, run.device, body),
            "kind": "classify", "peaks": run.peaks, "measured_s": self.window_s,
            "flops": work["flops"] * self.batch * len(self.done),
            "units": n,
            "scan_bytes": request_bytes * n,
        }
        replays = [s.counts.get("graph_replays") for s in recorded() or ()
                   if s.name == "classifier"]
        print(f"classifier spans' graph_replays: {replays}", file=sys.stderr)
        return ctx

    def trace_hooks(self):
        """No harness spans beyond the request: the program's own spans
        split it (``Classifier.classify``)."""

    # -- the check --------------------------------------------------------
    def release(self):
        del self.classifier
        sync(self.run.device)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, products: Products) -> Dict[int, torch.Tensor]:
        """The reference's logits of each checked request's rows, with its
        products at ``products``' precision, by position in the sample."""
        set_plain_float32()
        ref = ref_vssm.VSSM(self.run.cfg_dict, products).to(self.run.device)
        ref.load_state_dict(self.state)
        ref.eval()
        return {k: ref_vssm.logits(ref, self.pool[i][rows].to(self.run.device)).cpu()
                for k, (i, rows, _, _) in enumerate(self.sample)}

    def program_readings(self) -> Dict[int, torch.Tensor]:
        return {k: logits for k, (_, _, logits, _) in enumerate(self.sample)}

    def readings_against(self, ref: Dict[int, torch.Tensor], side: Dict[int, torch.Tensor]
                         ) -> Dict[str, float]:
        """``logit_gap``: the largest |side − reference| over the checked
        rows, over the largest |reference| there."""
        gap = max(float((side[k].double() - ref[k].double()).abs().max()) for k in ref)
        scale = max(float(ref[k].double().abs().max()) for k in ref)
        return {"logit_gap": gap / max(scale, 1e-30)}

    def state_gaps(self, sides=("program",)) -> Dict[str, float]:
        """``state_gap`` of each side: over every scan call of the program's
        forward of each sampled request, the largest |y_side − y_ref| on the
        checked rows over the largest |y_ref − D·u| there (the states' part
        of y), y_ref being the fp32 reference scan (``reference/scan.py``)
        on the route's own inputs. The forward is the served model's, run
        eagerly at the request's batch, the shapes its graph replays.

        Sides: ``program`` (the route's y), ``fp32``/``bf16``/``fp8`` (the
        reference scan with its operands u, Δ, B and C rounded as
        ``Products`` rounds a product's), ``fault_state`` (the reference
        scan with its last state channel's C zeroed)."""
        from vm_asr_tpu_torch.models import ss2d
        from vm_asr_tpu_torch.train.classifier import Classifier

        set_plain_float32()
        program = Classifier(self.run.cfg, self.model, device=self.run.device)
        route = ss2d.selective_scan
        gaps = dict.fromkeys(sides, 0.0)
        rows = None

        def read(u, dts, a_neg, bs, cs, ds, dt_bias, *args, **kwargs):
            y = route(u, dts, a_neg, bs, cs, ds, dt_bias, *args, **kwargs)
            u_, dts_, bs_, cs_, y_ = (t[rows].float() for t in (u, dts, bs, cs, y))
            ds_, bias_ = ds.float(), dt_bias.float()
            want = ref_scan.selective_scan(u_, dts_, a_neg.float(), bs_, cs_, ds_, bias_)
            scale = float((want - ds_[None, None] * u_).abs().max())
            for side in sides:
                if side == "program":
                    got = y_
                elif side == "fault_state":
                    cut = cs_.clone()
                    cut[..., -1] = 0
                    got = ref_scan.selective_scan(u_, dts_, a_neg.float(), bs_, cut, ds_, bias_)
                else:
                    q = Products(side).q
                    got = ref_scan.selective_scan(q(u_), q(dts_), a_neg.float(), q(bs_), q(cs_),
                                                  ds_, bias_)
                gap = float((got - want).abs().max()) / max(scale, 1e-30)
                gaps[side] = max(gaps[side], gap)
            return y

        ss2d.selective_scan = read
        try:
            for i, checked, _, _ in self.sample:
                rows = torch.as_tensor(checked, device=self.run.device)
                with torch.inference_mode():
                    program.model(program.load_input(self.pool[i]))
        finally:
            ss2d.selective_scan = route
        return gaps

    def check(self) -> Dict[str, dict]:
        """Each sampled request's logits on its checked rows against the
        fp32 reference's of the same images, its scan route against the
        reference's scan (``state_gaps``), and its top-5 ids against its own
        logits' (a wrong id fails)."""
        ref = self.reference_readings(Products("fp32"))
        values = self.readings_against(ref, self.program_readings())
        values["state_gap"] = self.state_gaps()["program"]
        values["top5_misses"] = sum(
            int((logits.topk(top5.shape[-1], dim=-1).indices != top5).any(dim=-1).sum())
            for _, _, logits, top5 in self.sample)
        return compare.checked(values, self.run.limits["limits"])
