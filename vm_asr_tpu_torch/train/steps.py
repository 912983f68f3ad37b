"""Train, eval and inference steps, and segment bucketing (port of
vm_asr_tpu/train/steps.py; reference trainer/trainer.py:98-438).

One train step: one generator forward in training mode; the generator loss
(L1 / L2 / multi-resolution STFT, plus, with GAN training, the adversarial
and feature-matching terms from each discriminator run on real and fake as
one batch with its spectral-norm statistics frozen); the generator's
gradient, taken over its own parameters only, and its update; then each
discriminator's loss on real and on the detached fake from before the
generator's update (two calls, each advancing the power iteration), its
gradient and update; then the metrics. The metric names are the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from .. import losses as L
from ..metrics import get_metrics


def build_gen_loss_terms(config):
    """(generator loss names, keyword arguments of the STFT loss)."""
    adv = config.TRAIN.ADVERSARIAL
    stft_kwargs = dict(
        factor_sc=adv.STFT_LOSS.SC_FACTOR,
        factor_mag=adv.STFT_LOSS.MAG_FACTOR,
        emphasize_high_freq=adv.STFT_LOSS.EMPHASIZE_HIGH_FREQ,
    )
    return tuple(config.TRAIN.LOSSES.GEN), stft_kwargs


def _waveform_terms(gen_losses, stft_kwargs, wave_out, y) -> Dict[str, torch.Tensor]:
    terms = {}
    if "l1" in gen_losses:
        terms["l1"] = L.mae_loss(wave_out, y)
    if "l2" in gen_losses:
        terms["l2"] = L.mse_loss(wave_out, y)
    if "multi_resolution_stft" in gen_losses:
        sc, mag = L.multi_resolution_stft_loss(wave_out[:, 0, :], y[:, 0, :], **stft_kwargs)
        terms["multi_resolution_stft"] = sc + mag
    return terms


def make_train_step(config, generator: torch.nn.Module,
                    discriminators: Dict[str, torch.nn.Module]) -> Callable:
    """Returns train_step(gen_state, disc_states, batch, rng) → (gen_state,
    disc_states, metrics), updating the states in place.

    ``batch``: {"wave_input", "wave_target": (B, 1, T), "highcut": (B,)} on
    the models' device; ``rng``: a ``torch.Generator`` on that device, which
    feeds the generator's DropPath masks.
    ``train_step.gen_loss_fn(x, y, hf, rng)`` → (total, wave_out, terms) is
    the generator's loss, for gradient checks. GAN_LOSS_TYPE "wgan-gp" (the
    gradient penalty in the discriminator step) is not ported yet and
    raises; ``losses.gradient_penalty`` is."""
    gen_losses, stft_kwargs = build_gen_loss_terms(config)
    adv = config.TRAIN.ADVERSARIAL
    gan = bool(adv.ENABLE) and len(discriminators) > 0
    gan_type = adv.GAN_LOSS_TYPE
    if gan and gan_type == "wgan-gp":
        raise NotImplementedError("GAN_LOSS_TYPE wgan-gp: the penalty's step is not ported yet")
    metric_fns = get_metrics(config.TRAIN.METRICS)
    disc_names = tuple(sorted(discriminators))
    disc_gain = float(adv.get("DISC_INPUT_GAIN", 1.0))

    def disc_forward(name, real, fake, update_stats):
        if disc_gain != 1.0:
            real = real * disc_gain
            fake = None if fake is None else fake * disc_gain
        return discriminators[name](real, fake, update_stats=update_stats)

    def gen_loss_fn(x, y, hf, rng):
        generator.train()
        wave_out = generator(x, hf, generator=rng)
        terms = _waveform_terms(gen_losses, stft_kwargs, wave_out, y)
        if gan:
            for name in disc_names:
                _, y_g, f_r, f_g = disc_forward(name, y, wave_out, update_stats=False)
                if not adv.ONLY_FEATURE_LOSS:
                    terms[f"adversarial_{name}"] = L.generator_adversarial_loss(y_g, gan_type)
                if not adv.ONLY_ADVERSARIAL_LOSS:
                    terms[f"features_{name}"] = adv.FEATURE_LOSS_LAMBDA * \
                        L.feature_matching_loss(f_r, f_g)
        return sum(terms.values()), wave_out, terms

    def disc_loss(name, y, fake):
        y_r, y_g, _, _ = disc_forward(name, y, fake, update_stats=True)
        gaps = torch.stack([dr.float().mean() - dg.float().mean() for dr, dg in zip(y_r, y_g)])
        return L.discriminator_loss(y_r, y_g, gan_type), gaps

    def train_step(gen_state, disc_states, batch, rng: torch.Generator):
        x, y, hf = batch["wave_input"], batch["wave_target"], batch["highcut"]
        g_total, wave_out, g_terms = gen_loss_fn(x, y, hf, rng)
        # Over the generator's parameters only: no gradient builds up in D.
        g_grads = torch.autograd.grad(g_total, gen_state.params, allow_unused=True,
                                      materialize_grads=True)
        gen_state.apply_gradients(g_grads)

        metrics = {"total_loss": g_total.detach()}
        metrics.update({f"generator/{k}": v.detach() for k, v in g_terms.items()})
        if gan:
            fake = wave_out.detach()
            d_total = 0.0
            for name in disc_names:
                ds = disc_states[name]
                d_loss, gaps = disc_loss(name, y, fake)
                d_grads = torch.autograd.grad(d_loss, ds.params, allow_unused=True,
                                              materialize_grads=True)
                ds.apply_gradients(d_grads)
                metrics[f"discriminator/{name}"] = d_loss.detach()
                metrics[f"disc_gap/{name}"] = gaps.detach().mean()
                metrics[f"disc_gap/{name}_max"] = gaps.detach().abs().max()
                d_total = d_total + d_loss.detach()
            metrics["total_disc_loss"] = d_total
        with torch.no_grad():
            out_flat, y_flat = wave_out.detach()[:, 0, :], y[:, 0, :]
            for mname, fn in metric_fns.items():
                metrics[mname] = fn(out_flat, y_flat, hf=hf)
        return gen_state, disc_states, metrics

    train_step.gen_loss_fn = gen_loss_fn
    return train_step


def make_eval_step(config, generator: torch.nn.Module) -> Callable:
    """eval_step(batch) → (wave_out, metrics): forward in eval mode, the
    waveform losses and the metrics, no updates (reference
    trainer.py:224-316)."""
    gen_losses, stft_kwargs = build_gen_loss_terms(config)
    metric_fns = get_metrics(config.TRAIN.METRICS)

    def eval_step(batch):
        x, y, hf = batch["wave_input"], batch["wave_target"], batch["highcut"]
        generator.eval()
        with torch.no_grad():
            wave_out = generator(x, hf)
            terms = _waveform_terms(gen_losses, stft_kwargs, wave_out, y)
            metrics: Dict[str, Any] = {f"generator/{k}": v for k, v in terms.items()}
            metrics["total_loss"] = sum(terms.values()) if terms else 0.0
            out_flat, y_flat = wave_out[:, 0, :], y[:, 0, :]
            for mname, fn in metric_fns.items():
                metrics[mname] = fn(out_flat, y_flat, hf=hf)
        return wave_out, metrics

    return eval_step


def make_forward_fn(generator: torch.nn.Module) -> Callable:
    """forward(x, hf) → the generator's output, in eval and inference mode."""
    generator.eval()

    def forward(x: torch.Tensor, hf: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return generator(x, hf)

    return forward


# Segment-batch sizes for long clips: at most 8 segments per forward, and
# the tail chunk padded up to the next size, as the JAX package does (there
# to bound XLA's compiles; here it bounds the batch shapes a run sees).
SEG_BUCKETS = (1, 2, 4, 8)


def segment_bucket_counts(num_segments: int) -> Dict[int, int]:
    """How many chunks of each bucket size ``bucketed_forward`` runs for a
    ``num_segments``-segment clip."""
    counts, i = {}, 0
    while i < num_segments:
        rem = min(num_segments - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        counts[b] = counts.get(b, 0) + 1
        i += rem
    return counts


def bucketed_forward(forward: Callable, seg_batch: torch.Tensor,
                     hf_batch: torch.Tensor) -> torch.Tensor:
    """Run S segments in chunks of at most 8, each padded to a bucket size.

    seg_batch: (S, 1, seg_len); hf_batch: (S,). Tail chunks are zero-padded
    (hf edge-padded) and the padded outputs dropped.
    """
    s = seg_batch.shape[0]
    outs = []
    i = 0
    while i < s:
        rem = min(s - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        chunk = seg_batch[i:i + rem]
        hfc = hf_batch[i:i + rem]
        if rem < b:
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, b - rem))
            hfc = torch.cat([hfc, hfc[-1:].expand(b - rem)])
        outs.append(forward(chunk, hfc)[:rem])
        i += rem
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
