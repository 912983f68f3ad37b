"""Serving traffic: one client sends wav files to ``Inferencer.infer_file``,
one after another (a closed loop, as ``--inference`` over a directory).

The mix (``traffic/<mix>.json``) gives the clips' input rate, the pool's
size, the length distribution (the pool holds its quantiles, the same for
every seed), how many finished requests the check samples, and how many
requests the profiler covers. The seed draws the clips' content and the
order in which the client sends them. A request is timed from the call to
its return, with the enhanced wav written; a request that raises counts as
failed and as lasting the whole window.
"""

from __future__ import annotations

import random
import time
import traceback
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from scipy.io import wavfile

from .. import compare, program, synth
from ..counters import scan_bytes, work
from ..reference import serve as ref_serve
from ..reference.generator import Generator
from ..reference.precision import Products, set_plain_float32
from ..trace import profiled, sync


def segments_of(samples: int, seg: int, overlap: int) -> int:
    """Segments a clip of ``samples`` at the target rate is cut into, after
    its padding to whole segments (the published inference path)."""
    t = seg if samples <= seg else -(-samples // seg) * seg
    return 1 + max(0, t - seg) // (seg - overlap)


class Job:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        cfg = run.cfg
        self.target_sr = int(cfg.TAG.split("_")[1])
        self.seg = int(cfg.DATA.SEGMENT * self.target_sr)
        self.overlap = cfg.INFERENCE.OVERLAP

    # -- set-up -----------------------------------------------------------
    def setup(self):
        run, mix, dev = self.run, self.mix, self.run.device
        sr = mix["input_sr"]
        secs = synth.lengths(mix, mix["pool"])
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        clips = synth.speech([int(s * sr) for s in secs], sr, gen, dev)
        clip_dir = run.tmp / "clips"
        clip_dir.mkdir()
        self.paths, self.audio_s, self.segments = [], [], []
        for i, c in enumerate(clips):
            path = clip_dir / f"clip_{i:03d}.wav"
            wavfile.write(path, sr, (c.cpu().numpy() * 32767.0).astype(np.int16))
            self.paths.append(str(path))
            self.audio_s.append(c.numel() / sr)
            out_len = -(-c.numel() * self.target_sr // sr)
            self.segments.append(segments_of(out_len, self.seg, self.overlap))
        run.mark("clips")
        self.states = program.seeded_states(run.cfg_dict, run.seed, dev, discriminator=False)
        from vm_asr_tpu_torch.train import Inferencer

        self.out_dir = run.tmp / "enhanced"
        self.inferencer = Inferencer(run.cfg, program.generator(run.cfg, self.states["generator"],
                                                                dev),
                                     logger=run.log, output_dir=str(self.out_dir), device=dev)
        run.mark("program")
        if run.fault is not None:
            run.fault(self)
        self.rng = np.random.default_rng(run.seed)
        # Every request shape of the traffic, twice: one clip of each
        # segment count in the pool.
        shapes = {}
        for i, n in enumerate(self.segments):
            shapes.setdefault(n, i)
        for _ in range(2):
            for i in shapes.values():
                self.request(i)
            run.mark("warm-up")

    def order(self):
        """The client's requests: seeded permutations of the pool, one after
        another."""
        while True:
            yield from (int(i) for i in self.rng.permutation(len(self.paths)))

    def request(self, i: int):
        return self.inferencer.infer_file(self.paths[i], str(self.out_dir), quiet=True)

    # -- the measured window ---------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        keep = self.mix["sample"]
        pick = random.Random(self.run.seed)
        longest = int(np.argmax(self.audio_s))
        self.sample: List[tuple] = []
        self.longest = None
        lat, failed, audio, done = [], 0, 0.0, []
        order = self.order()
        t0 = time.perf_counter()
        end = t0
        while end - t0 < seconds:
            i = next(order)
            ts = time.perf_counter()
            try:
                with self.run.spans.span("request"):
                    out = self.request(i)
                ok = out is not None
            except Exception:  # a failed request: counted, and the client goes on
                traceback.print_exc()
                ok, out = False, None
            end = time.perf_counter()
            if not ok:
                failed += 1
                continue
            lat.append(end - ts)
            audio += self.audio_s[i]
            done.append(i)
            n = len(done)
            if i == longest and self.longest is None:
                self.longest = (i, out)
            elif len(self.sample) < keep:
                self.sample.append((i, out))
            elif pick.random() < keep / n:
                self.sample[pick.randrange(keep)] = (i, out)
        window_s = end - t0
        lat += [window_s] * failed
        self.done, self.window_s = done, window_s
        return {"serve_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else 0.0,
                "serve_audio_s_per_s": audio / window_s,
                "attempted": len(done) + failed, "failed": failed}

    # -- the traced run ---------------------------------------------------
    def traced(self) -> dict:
        """Per-layer readings: host spans of the measured window (which ran
        with the spans on, its forwards synchronised at their end so that
        their device time falls inside them), then a profiled sub-window of
        ``profile_requests`` requests."""
        run, cfg_d = self.run, self.run.cfg_dict
        spans = run.spans
        window_s, done = self.window_s, self.done
        request_s, forward_s = spans.total("request"), spans.total("forward")
        requests = spans.count("request")
        seg_work = work.segment_work(cfg_d, self.seg)
        itemsize = scan_bytes.scan_itemsize(cfg_d)
        seg_bytes = scan_bytes.total_bytes(seg_work["scan_calls"], itemsize, backward=False)
        # The profiler replays the window's first requests: their device
        # time beside the wall they took unprofiled (the profiler slows the
        # host, not the device).
        n = min(self.mix["profile_requests"], len(done))
        prof_ids = done[:n]
        walls = [e - s for name, s, e in spans.records if name == "request"][:n]

        def body():
            for i in prof_ids:
                with spans.span("request"):
                    self.request(i)

        return {
            **profiled(spans, run.device, body),
            "kind": "serve", "peaks": run.peaks,
            "measured_s": window_s,
            "flops": seg_work["flops"] * sum(self.segments[i] for i in done),
            "request_s": request_s, "forward_s": forward_s, "requests": requests,
            "units": n, "unprofiled_wall_us": sum(walls) * 1e6,
            "scan_bytes": seg_bytes * sum(self.segments[i] for i in prof_ids),
        }

    def trace_hooks(self):
        """Spans around the request layer's pieces, for the traced run."""
        self.run.spans.wrap(self.inferencer, "load_input", "load")
        self.run.spans.wrap(self.inferencer, "forward_chunked", "forward",
                            after=lambda: sync(self.run.device))

    # -- the check --------------------------------------------------------
    def release(self):
        del self.inferencer
        sync(self.run.device)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked_requests(self) -> List[tuple]:
        """(clip, returned waveform) of the requests the check compares: the
        seeded sample and the longest clip's first request."""
        return self.sample + ([self.longest] if self.longest else [])

    def reference_readings(self, products: Products) -> Dict[int, torch.Tensor]:
        """The reference's enhancement of each checked clip from its wav
        file, with its products at ``products``' precision."""
        run = self.run
        set_plain_float32()
        ref = Generator(run.cfg_dict, products).to(run.device)
        ref.load_state_dict(self.states["generator"])
        ref.eval()
        return {i: ref_serve.enhance(ref, run.cfg_dict, self.paths[i], run.device)
                for i, _ in self.checked_requests()}

    def readings_against(self, ref: Dict[int, torch.Tensor],
                         side: Dict[int, torch.Tensor], written: Dict[int, torch.Tensor]
                         ) -> Dict[str, float]:
        """The widest relative gap over the checked clips of a waveform as
        returned (``side``) and as written (``written``) to the reference's
        (quantised as the wav is written, for the latter)."""
        return {"out_gap": max(compare.rel_gap(side[i], ref[i]) for i in ref),
                "wav_gap": max(compare.rel_gap(written[i], quantised(ref[i]).cpu())
                               for i in ref)}

    def program_readings(self):
        """The program's checked waveforms, as returned and as read back from
        the wav files it wrote."""
        returned = {i: out[0, 0].float() for i, out in self.checked_requests()}
        written = {}
        for i, _ in self.checked_requests():
            path = Path(self.out_dir) / f"{Path(self.paths[i]).stem}_enhanced.wav"
            written[i] = torch.from_numpy(ref_serve.read_wav(str(path))[0])
        return returned, written

    def check(self) -> Dict[str, dict]:
        """Each sampled request's enhanced waveform, as returned and as
        written, against the reference's enhancement of the same wav file."""
        returned, written = self.program_readings()
        ref = self.reference_readings(Products("fp32"))
        return compare.checked(self.readings_against(ref, returned, written),
                               self.run.limits["limits"])


def quantised(w: torch.Tensor) -> torch.Tensor:
    """A waveform as a 16-bit wav holds it."""
    return torch.trunc(w.clamp(-1, 1) * 32767) / 32768
