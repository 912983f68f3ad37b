"""Training traffic: the published GAN step, ``Trainer.train_step`` (the
generator, the MPD and AdamW twice), on batches that sit on the device.

The mix gives the batch, the pool of distinct batches, the steps an epoch
(the learning-rate schedule's unit), the warm-up steps after the three
that the check follows, and the steps the profiler covers. The seed draws
each item's speech, its input rate (uniform over DATA.RANDOM_RESAMPLE, as
the published sampler draws it), and the order of the batches; every batch has
the configured shape. An input is its target with
every bin at or above half its input rate zeroed, and its highcut bin is
(1 + n_fft // 2) · rate / target rate, as the published sampler has it.

Set-up builds one Trainer and drives it from the seed through its first
steps, on batches that all differ; the window goes on with the same
objects. The check reads, from those first three steps: each step's two
losses, each parameter's first gradient as AdamW got it (its first moment
after step 1 over 1 − β1), each parameter's change after step 3, and the
DropPath masks the program drew, which forward hooks on its DropPath
modules record (a row is kept where the module's output is not all zero)
and the reference's steps take in the same order, so that the check does
not depend on how the program draws them.
"""

from __future__ import annotations

import time
import traceback
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .. import compare, program, synth
from ..counters import scan_bytes, work
from ..reference.generator import Generator
from ..reference.precision import Products, set_plain_float32
from ..reference.train import Recorded, Step
from ..trace import profiled, sync

CHECKED_STEPS = 3
# The generator's leaves that take their gradient through the selective
# scan's backward (dB, dC through x_proj; dΔ through dt_projs; dA; dD).
SCAN_LEAVES = ("x_proj_weight", "dt_projs_weight", "dt_projs_bias", "A_logs", "Ds")


class _Epoch:
    """What the Trainer asks of a loader before its epoch loop: a length."""

    def __init__(self, steps: int):
        self.steps = steps

    def __len__(self):
        return self.steps


def _block_of(name: str, blocks: List[str]) -> str:
    """The reference's VSS block whose name is the longest prefix of the
    module name ``name``, or ""."""
    hits = [b for b in blocks if name.startswith(b + ".")]
    return max(hits, key=len) if hits else ""


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([t.detach().double().norm() for t in tensors.values()]).tolist()
    return dict(zip(names, values))


class Job:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        cfg = run.cfg
        self.batch = self.mix["batch"]
        self.target_sr = cfg.DATA.TARGET_SR
        self.seg = int(cfg.DATA.SEGMENT * self.target_sr)

    def _batches(self) -> List[dict]:
        run, dev, cfg = self.run, self.run.device, self.run.cfg
        n, b = self.mix["pool"], self.batch
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        y = torch.stack(synth.speech([self.seg] * (n * b), self.target_sr, gen, dev))
        lo, hi = cfg.DATA.RANDOM_RESAMPLE[0], cfg.DATA.RANDOM_RESAMPLE[-1]
        rates = torch.randint(lo, hi + 1, (n * b,), generator=gen, device=dev)
        x = synth.lowpass(y, rates / 2, self.target_sr)
        hf = ((1 + cfg.DATA.STFT.N_FFT // 2) * rates / self.target_sr).long()
        return [{"wave_input": x[i * b:(i + 1) * b, None].contiguous(),
                 "wave_target": y[i * b:(i + 1) * b, None].contiguous(),
                 "highcut": hf[i * b:(i + 1) * b]} for i in range(n)]

    # -- set-up -----------------------------------------------------------
    def setup(self):
        run, dev, mix = self.run, self.run.device, self.mix
        self.pool = self._batches()
        rng = np.random.default_rng(run.seed)
        # Seeded permutations of the pool, one after another: the first
        # steps all see different batches.
        self.order = [int(i) for _ in range(256) for i in rng.permutation(len(self.pool))]
        run.mark("batches")
        self.states = program.seeded_states(run.cfg_dict, run.seed, dev, discriminator=True)
        from vm_asr_tpu_torch.train import Trainer

        models = {"generator": program.generator(run.cfg, self.states["generator"], dev)}
        models.update(program.discriminators(run.cfg, {"mpd": self.states["mpd"]}, dev))
        self.trainer = Trainer(run.cfg, models, _Epoch(mix["steps_per_epoch"]), None,
                               logger=run.log)
        self.step_fn = self.trainer.train_step
        run.mark("program")
        if run.fault is not None:
            run.fault(self)
        self.rng_seed = run.seed * 7919 + 1
        self.rng = torch.Generator(device=dev).manual_seed(self.rng_seed)
        self.steps = 0
        hooks = self._record_masks(models["generator"])
        self.masks: List[Dict[str, List[torch.Tensor]]] = []
        states = [self.trainer.gen_state, *self.trainer.disc_states.values()]
        named = {f"{k}.{n}": p for k, s in zip(["generator", *self.trainer.disc_states], states)
                 for n, p in s.module.named_parameters() if p.requires_grad}
        start = {k: p.detach().clone() for k, p in named.items()}
        losses = []
        for _ in range(CHECKED_STEPS):
            self._drawn = defaultdict(list)
            metrics = self.step()
            self.masks.append(dict(self._drawn))
            sync(dev)
            run.mark(f"step {self.steps}")
            losses.append(torch.stack([metrics["total_loss"], metrics["total_disc_loss"]]))
            if self.steps == 1:
                first = {}
                for k, s in zip(["generator", *self.trainer.disc_states], states):
                    beta1 = s.optimizer.tx.param_groups[0]["betas"][0]
                    for n, p in s.module.named_parameters():
                        st = s.optimizer.tx.state.get(p, {})
                        if p.requires_grad:
                            first[f"{k}.{n}"] = st["exp_avg"] / (1 - beta1) if "exp_avg" in st \
                                else torch.zeros_like(p)
                self.first_grads = _norms(first)
        self.changes = _norms({k: p.detach() - start[k] for k, p in named.items()})
        self.losses = torch.stack(losses).tolist()
        for h in hooks:
            h.remove()
        del start, first, self._drawn
        run.mark("readings")
        for _ in range(mix["warmup_steps"]):
            self.step()
        sync(dev)
        run.mark("warm-up")

    def _record_masks(self, model: torch.nn.Module) -> list:
        """Forward hooks on the program's DropPath modules (by class name)
        that record, for the reference's VSS block holding each, the rows a
        call kept."""
        with torch.device("meta"):
            blocks = Generator(self.run.cfg_dict, Products()).block_names()

        def hook(block):
            def record(module, inputs, output):
                self._drawn[block].append(output.detach().reshape(output.shape[0], -1)
                                          .ne(0).any(1))
            return record

        return [m.register_forward_hook(hook(_block_of(name, blocks)))
                for name, m in model.named_modules() if "DropPath" in type(m).__name__]

    def step(self):
        batch = self.pool[self.order[self.steps % len(self.order)]]
        tr = self.trainer
        tr.gen_state, tr.disc_states, metrics = self.step_fn(tr.gen_state, tr.disc_states, batch,
                                                              self.rng)
        self.steps += 1
        return metrics

    # -- the measured window ---------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        spans = self.run.spans
        steps, failed = 0, 0
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < seconds:
                with spans.span("step"):
                    self.step()
                steps += 1
            sync(self.run.device)
        except Exception:  # a step that raises ends the window and the run's correctness
            traceback.print_exc()
            failed = 1
        window_s = time.perf_counter() - t0
        self.window_steps, self.window_s = steps, window_s
        audio = steps * self.batch * self.seg / self.target_sr
        return {"train_audio_s_per_s": audio / window_s, "attempted": steps + failed,
                "failed": failed}

    def trace_hooks(self):
        pass

    # -- the traced run ---------------------------------------------------
    def traced(self) -> dict:
        run, cfg_d = self.run, self.run.cfg_dict
        step_work = work.step_work(cfg_d, self.batch, self.seg)
        itemsize = scan_bytes.scan_itemsize(cfg_d)
        step_bytes = scan_bytes.total_bytes(step_work["scan_calls"], itemsize, backward=True)
        n = self.mix["profile_steps"]

        def body():
            for _ in range(n):
                with run.spans.span("step"):
                    self.step()

        return {
            **profiled(run.spans, run.device, body),
            "kind": "train", "peaks": run.peaks,
            "measured_s": self.window_s, "flops": step_work["flops"] * self.window_steps,
            "units": n,
            "unprofiled_wall_us": n * self.window_s / max(self.window_steps, 1) * 1e6,
            "scan_bytes": step_bytes * n,
        }

    # -- the check --------------------------------------------------------
    def release(self):
        sync(self.run.device)
        del self.trainer, self.step_fn
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, products: Products, rows=None) -> dict:
        """The reference's losses, first gradients and changes over the
        same first steps (``rows``: the batch rows it is given)."""
        run = self.run
        set_plain_float32()
        ref = Step(run.cfg_dict, self.states["generator"], self.states["mpd"],
                   self.mix["steps_per_epoch"], products, run.device)
        named = {**{f"generator.{k}": p for k, p in ref.gen_params.items()},
                 **{f"mpd.{k}": p for k, p in ref.mpd_params.items()}}
        start = {k: p.detach().clone() for k, p in named.items()}
        losses, misses = [], 0
        for i in range(CHECKED_STEPS):
            batch = self.pool[self.order[i]]
            x, y = batch["wave_input"], batch["wave_target"]
            if rows is not None:
                x, y = x[rows], y[rows]
            masks = Recorded(self.masks[i], rows)
            losses.append(ref(x, y, masks))
            misses += masks.misses
            if i == 0:
                first = {**{f"generator.{k}": m / (1 - ref.gen_opt.b1)
                            for k, m in ref.gen_opt.m.items()},
                         **{f"mpd.{k}": m / (1 - ref.mpd_opt.b1) for k, m in ref.mpd_opt.m.items()}}
                first_grads = _norms(first)
        changes = _norms({k: p.detach() - start[k] for k, p in named.items()})
        return {"losses": losses, "first_grads": first_grads, "changes": changes,
                "mask_misses": misses}

    def leaf_gaps(self, ref: dict, prog: dict):
        """Per leaf of each model, the first-gradient gap and, over the leaves
        the reference moves by more than rounding (first gradient at least
        1e-3 of the median leaf's), the change gap."""
        grads, changes = {}, {}
        for model in ("generator.", "mpd."):
            rg = {k: v for k, v in ref["first_grads"].items() if k.startswith(model)}
            rc = {k: v for k, v in ref["changes"].items() if k.startswith(model)}
            floor = 1e-3 * compare.median(rg.values())
            moved = [k for k, v in rg.items() if v >= floor]
            grads[model] = compare.leaf_gaps(prog["first_grads"], rg)
            changes[model] = compare.leaf_gaps(prog["changes"], rc, keep=moved)
        return grads, changes

    @staticmethod
    def scan_leaves(ref: dict) -> List[str]:
        """The generator's scan-fed leaves whose reference first gradient is
        at least 1e-3 of the median generator leaf's."""
        rg = {k: v for k, v in ref["first_grads"].items() if k.startswith("generator.")}
        floor = 1e-3 * compare.median(rg.values())
        return [k for k, v in rg.items() if k.endswith(SCAN_LEAVES) and v >= floor]

    def scan_gaps(self, ref: dict, prog: dict) -> Dict[str, float]:
        """Per scan-fed leaf, the gap of its first gradient's norm relative
        to its own reference norm: these leaves lie at 0.1-1 % of the median
        leaf, so against the median's norm a scan backward that returned no
        dB or dC would read 0.01."""
        r, p = ref["first_grads"], prog["first_grads"]
        return {k: abs(p.get(k, 0.0) - r[k]) / r[k] for k in self.scan_leaves(ref)}

    def readings_against(self, ref: dict, prog: dict) -> Dict[str, float]:
        """The numbers compared: the worst relative gap of a loss (both losses
        of each of the steps); over the leaves of each model the median
        leaf's first-gradient gap and change gap, the worse model's (the
        worst leaf's swing from seed to seed with the rounding of a few
        leaves whose gradients are sums that cancel, PERF.md); over each kind
        of scan-fed leaf (``scan_gaps``) the median leaf's first-gradient gap,
        the worst kind's, which a fault of the scan's backward moves while
        the median leaf of the model stays (their worst leaf swings with
        bf16's rounding of cancelling sums as the median leaf's does not,
        PERF.md); and the reference calls that found no DropPath mask of the
        program's."""
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                       for ps, rs in zip(prog["losses"], ref["losses"]) for p, r in zip(ps, rs))
        grads, changes = self.leaf_gaps(ref, prog)
        scan = self.scan_gaps(ref, prog)
        by_kind = [[v for k, v in scan.items() if k.endswith(kind)] for kind in SCAN_LEAVES]
        return {"loss_gap": loss_gap,
                "grad_gap": max(compare.median(g.values()) for g in grads.values()),
                "change_gap": max(compare.median(c.values()) for c in changes.values()),
                "scan_grad_gap": max((compare.median(v) for v in by_kind if v), default=0.0),
                "mask_misses": float(ref["mask_misses"])}

    def program_readings(self) -> dict:
        return {"losses": self.losses, "first_grads": self.first_grads, "changes": self.changes}

    def check(self) -> Dict[str, dict]:
        ref = self.reference_readings(Products("fp32"))
        return compare.checked(self.readings_against(ref, self.program_readings()),
                               self.run.limits["limits"])
