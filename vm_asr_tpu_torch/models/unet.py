"""MambaUNet and DualStreamInteractiveMambaUNet (port of
vm_asr_tpu/models/unet.py; reference model/model.py:119-1552).

waveform → STFT (513×F) → drop the DC bin (512×F) → patch embed (4× down)
→ encoder stages with PatchMerging → (latent layout: a bottleneck stage)
→ decoder stages with PatchExpanding and skips → output head (v1/v2/v3)
→ + residual magnitude → re-attach DC → iSTFT. Channels-last (NHWC)
throughout, as in the JAX package.

Kept from the reference, as the JAX package keeps them:
- In the standard layout (len(dims) == len(depths)) the first decoder stage
  receives the empty drop-path slice ``dpr[8:8]``: no blocks, no sampler, a
  pass-through. In the latent layout (len(dims) == len(depths) + 1) every
  encoder downsamples, one bottleneck VSSLayer runs at ``layers_latent.0``,
  and every decoder stage and the head take a skip.
- In concat-skip mode the phase stream runs through the *magnitude*
  decoder (model.py:1148) unless ``phase_decoder_fix``; the phase decoders
  are then never built, and a reference checkpoint's
  ``layers_decoder_phase.*`` is dropped on load.
- The dual-stream forward does not normalise the magnitude; MambaUNet
  standardises it per sample (unbiased std).
- The "dual" interaction is two sequential adds; "p2m" and "m2p" one each;
  "single" builds no phase stream and passes the phase through.
- LOW_FREQ_REPLACEMENT in "torch" mode is a no-op on (B, 1, T) input.

Stacked execution (``DualStreamStackedMambaUNet``, serving only): the two
streams run as one (2, B, ...) tensor through ``torch.func.vmap`` over one
stream's stage modules with their weights stacked on a leading axis of 2
(``stack_dual_state``), each op once for both streams.

Module names are the reference's (``patch_embed_mag``,
``layers_encoder_mag``, ``layers_latent_mag``, ``layers_decoder_mag``,
``output_layer_mag`` and the ``_phase`` twins; bare names for MambaUNet), so
its ``state_dict`` keys are too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call, vmap

from ..dsp import spectro2wav, wav2spectro
from .layers import Conv1x1, ConvTranspose2d, PatchEmbed
from .vss import VSSLayer


def resolve_dims(dims, num_layers: int) -> List[int]:
    if isinstance(dims, int):
        return [dims * 2**i for i in range(num_layers)]
    return list(dims)


class HeadV3(nn.Sequential):
    """v3 head: VSS(dim0, identity norm, skip, expand+LN) → VSS(dim0/2, LN,
    expand+LN) → 1×1 conv → VSS(in_chans, identity norm), in the reference's
    Sequential slots 0/1/3/5 (model.py:773-887)."""

    def __init__(self, dim0: int, in_chans: int, drop_path, concat_skip: bool,
                 compute_dtype: torch.dtype, **block_kwargs):
        common = dict(drop_path=drop_path, compute_dtype=compute_dtype, **block_kwargs)
        super().__init__(
            VSSLayer(dim0, use_norm=False, sampler=("expand", True),
                     concat_skip=concat_skip, **common),
            VSSLayer(dim0 // 2, use_norm=True, sampler=("expand", True), **common),
            nn.Identity(),
            Conv1x1(dim0 // 4, in_chans, compute_dtype=compute_dtype),
            nn.Identity(),
            VSSLayer(in_chans, use_norm=False, **common),
        )

    def forward(self, x, generator=None):
        return self[5](self[3](self[1](self[0](x, generator), generator)), generator)


class HeadV2(nn.Sequential):
    """v2 head: VSS(dim0, LN, skip, expand) → VSS(dim0/2, LN, expand), each
    with the last stage's drop paths, → a 1×1 conv where dim0/4 ≠ in_chans,
    in slots 0/1/3 (reference model.py:675-771)."""

    def __init__(self, dim0: int, in_chans: int, drop_path, concat_skip: bool,
                 compute_dtype: torch.dtype, **block_kwargs):
        common = dict(drop_path=drop_path, compute_dtype=compute_dtype, **block_kwargs)
        mods = [VSSLayer(dim0, sampler=("expand", False), concat_skip=concat_skip, **common),
                VSSLayer(dim0 // 2, sampler=("expand", False), **common)]
        if dim0 // 4 != in_chans:
            mods += [nn.Identity(), Conv1x1(dim0 // 4, in_chans, compute_dtype=compute_dtype)]
        super().__init__(*mods)

    def forward(self, x, generator=None):
        x = self[1](self[0](x, generator), generator)
        return self[3](x) if len(self) > 3 else x


class HeadV1(nn.Module):
    """v1 head (JAX unet.py:233-250, 269-285): the skip's 1×1 conv (2·dim0 →
    dim0, concat skips only) → exact GELU → 3×3/s2 transposed conv (→ dim0/2)
    → GELU → 3×3/s2 transposed conv (→ in_chans). The reference's names for
    this head are unknown (the JAX package's converter rejects it and the
    reference tree is absent), so its modules carry the JAX package's names:
    ``out_skip_conv``, ``out_convt1``, ``out_convt2``."""

    def __init__(self, dim0: int, in_chans: int, concat_skip: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.out_skip_conv = Conv1x1(2 * dim0, dim0, compute_dtype=compute_dtype) \
            if concat_skip else None
        self.out_convt1 = ConvTranspose2d(dim0, dim0 // 2, compute_dtype=compute_dtype)
        self.out_convt2 = ConvTranspose2d(dim0 // 2, in_chans, compute_dtype=compute_dtype)

    def forward(self, x, generator=None):
        if self.out_skip_conv is not None:
            x = self.out_skip_conv(x)
        return self.out_convt2(F.gelu(self.out_convt1(F.gelu(x))))


def build_stream(
    in_chans: int = 1,
    patch_size: int = 4,
    depths: Sequence[int] = (2, 2, 2, 2),
    dims=16,
    drop_path_rate: float = 0.1,
    patch_norm: bool = True,
    patchembed_version: str = "v2",
    output_version: str = "v3",
    concat_skip: bool = True,
    with_decoders: bool = True,
    *,
    compute_dtype: torch.dtype = torch.float32,
    **block_kwargs,
) -> dict:
    """One stream's modules, keyed by the reference's names (without the
    stream suffix): patch_embed, layers_encoder, layers_latent (latent
    layout), layers_decoder (when ``with_decoders``) and output_layer."""
    n = len(depths)
    dims = resolve_dims(dims, n)
    if len(dims) not in (n, n + 1):
        raise ValueError(f"dims must have {n} entries (standard U-Net) or {n + 1} "
                         f"(latent layout); got {len(dims)}")
    if patch_size != 4:
        # The JAX package builds such a stream and then fails to add its
        # residual: the heads upsample by 4 whatever the patch size.
        raise ValueError(f"patch size {patch_size}: the output heads upsample by 4")
    latent = len(dims) == n + 1
    dpr = list(np.linspace(0.0, drop_path_rate, sum(depths)))
    common = dict(compute_dtype=compute_dtype, **block_kwargs)

    def stage(lo, hi):
        return dpr[sum(depths[:lo]):sum(depths[:hi])]

    modules = {
        # The image has one channel; ``in_chans`` sets the head's output
        # channels (flax infers the embed's input width from the image).
        "patch_embed": PatchEmbed(1, dims[0], patch_size, patchembed_version, patch_norm,
                                  compute_dtype=compute_dtype),
        # Blocks at dims[i]; downsample at every stage end but the standard
        # layout's last (reference model.py:247-297).
        "layers_encoder": nn.ModuleList(
            VSSLayer(dims[i], stage(i, i + 1),
                     sampler=("merge", dims[i + 1]) if latent or i < n - 1 else None,
                     **common)
            for i in range(n)
        ),
    }
    if latent:
        # The bottleneck, with the last stage's drop paths (model.py:299-332).
        modules["layers_latent"] = nn.ModuleList([VSSLayer(dims[n], stage(n - 1, n), **common)])
    if with_decoders:
        # i_layer = n .. 1 (reference model.py:338-394).
        decoders = []
        for i_layer in range(n, 0, -1):
            inner = latent or i_layer < n
            dim = dims[i_layer] if latent or i_layer < n - 1 else dims[n - 1]
            decoders.append(VSSLayer(
                dim, stage(i_layer, i_layer + 1),
                sampler=("expand", True) if inner else None,
                concat_skip=concat_skip and inner, **common,
            ))
        modules["layers_decoder"] = nn.ModuleList(decoders)
    if output_version == "v3":
        head = HeadV3(dims[0], in_chans, dpr[-1:], concat_skip, **common)
    elif output_version == "v2":
        head = HeadV2(dims[0], in_chans, stage(n - 1, n), concat_skip, **common)
    elif output_version == "v1":
        head = HeadV1(dims[0], in_chans, concat_skip, compute_dtype)
    else:
        raise ValueError(f"unknown output version {output_version!r}")
    modules["output_layer"] = head
    return modules


class UNetCore:
    """One stream's stage functions over modules its owner registers
    (JAX package: models/unet.py:UNetCore); calling it runs the whole
    single-stream U-Net over an NHWC image, skips included."""

    def __init__(self, patch_embed, layers_encoder, output_layer, layers_decoder=None,
                 layers_latent=None, concat_skip: bool = True):
        self.patch_embed = patch_embed
        self.layers_encoder = layers_encoder
        self.layers_latent = layers_latent
        self.layers_decoder = layers_decoder
        self.output_layer = output_layer
        self.concat_skip = concat_skip

    @property
    def has_latent(self) -> bool:
        return self.layers_latent is not None

    def embed(self, x):
        return self.patch_embed(x)

    def encode(self, i: int, x, generator=None):
        return self.layers_encoder[i](x, generator)

    def run_latent(self, x, generator=None):
        return self.layers_latent[0](x, generator)

    def decode(self, i: int, x, generator=None):
        return self.layers_decoder[i](x, generator)

    def output(self, x, generator=None):
        return self.output_layer(x, generator)

    def join(self, x, skip):
        """A skip joined to the stream: concatenated or added."""
        return torch.cat([x, skip], dim=-1) if self.concat_skip else x + skip

    def __call__(self, x, generator=None):
        """Reference model.py:459-565, both layouts."""
        n = len(self.layers_encoder)
        x = self.embed(x)
        skips = [x]
        for i in range(n):
            x = self.encode(i, x, generator)
            if self.has_latent or i < n - 1:
                skips.append(x)
        if self.has_latent:
            x = self.run_latent(x, generator)
        for i in range(n):
            if self.has_latent or i != 0:
                x = self.join(x, skips.pop())
            x = self.decode(i, x, generator)
        return self.output(self.join(x, skips.pop()), generator)


def _low_band_mask(out, hf):
    freqs = out.shape[-2]
    return torch.arange(freqs, device=out.device)[None, :, None] < hf[:, None, None]


def _low_freq_replacement(out, orig, hf):
    """The intended reading of reference model.py:441-451: input bins
    [0, hf_b) copied into the output ("fixed" mode)."""
    return torch.where(_low_band_mask(out, hf), orig, out)


def _low_freq_replacement_torch_2d(out, orig, hf):
    """What the reference does on channel-less (B, F, T) tensors: model low
    band + input high band (model.py:441-446)."""
    return torch.where(_low_band_mask(out, hf), out, orig)


class SpectralUNet(nn.Module):
    """Base of the spectral U-Nets: waveform ↔ (log2-magnitude, phase) images
    and the low-frequency replacement."""

    def __init__(
        self,
        n_fft: int = 1024,
        hop_length: int = 240,
        win_length: int = 1024,
        spectro_scale: str = "log2",
        low_freq_replacement: bool = False,
        lfr_mode: str = "torch",
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.spectro_scale = spectro_scale
        self.low_freq_replacement = low_freq_replacement
        self.lfr_mode = lfr_mode
        self.compute_dtype = compute_dtype

    def _register_stream(self, modules: dict, suffix: str, concat_skip: bool) -> UNetCore:
        for name, module in modules.items():
            self.add_module(f"{name}{suffix}", module)
        return UNetCore(**modules, concat_skip=concat_skip)

    def _mag_phase(self, x):
        hop = self.hop_length
        if x.shape[-1] % hop:
            x = nn.functional.pad(x, (0, hop - x.shape[-1] % hop))
        return wav2spectro(x, self.n_fft, hop, self.win_length, self.spectro_scale)

    def _i_mag_phase(self, mag, phase):
        return spectro2wav(mag, phase, self.n_fft, self.hop_length, self.win_length,
                           self.spectro_scale)

    def _apply_lfr(self, mag, phase, x, hf, chan: bool):
        """Low-frequency replacement per ``lfr_mode``; ``chan``: whether the
        caller passed (B, 1, T), the rank that makes the reference's
        replacement a no-op."""
        if not self.low_freq_replacement or hf is None:
            return mag, phase
        if self.lfr_mode == "torch" and chan:
            return mag, phase
        mag_org, phase_org = self._mag_phase(x)
        fn = (_low_freq_replacement_torch_2d if self.lfr_mode == "torch"
              else _low_freq_replacement)
        mag = fn(mag, mag_org, hf)
        if phase is not None:
            phase = fn(phase, phase_org, hf)
        return mag, phase

    def _corrected(self, core: UNetCore, mag, generator):
        """``mag`` (B, 512, F) plus ``core``'s correction of it."""
        return core(mag[..., None].to(self.compute_dtype), generator)[..., 0].float() + mag


def _split_kwargs(kwargs):
    spectral = ("n_fft", "hop_length", "win_length", "spectro_scale", "low_freq_replacement",
                "lfr_mode", "compute_dtype")
    return ({k: kwargs.pop(k) for k in spectral if k in kwargs}, kwargs)


class MambaUNet(SpectralUNet):
    """Single-stream magnitude U-Net (reference model.py:119-577): predicts a
    correction of the per-sample standardised magnitude; the phase passes
    through. One stream with bare module names (``patch_embed.*``,
    ``layers_encoder.*``, …: the JAX package's ``core`` root)."""

    def __init__(self, concat_skip: bool = True, **kwargs):
        spectral, stream_kwargs = _split_kwargs(kwargs)
        super().__init__(**spectral)
        self.concat_skip = concat_skip
        self.core = self._register_stream(
            build_stream(concat_skip=concat_skip, compute_dtype=self.compute_dtype,
                         **stream_kwargs), "", concat_skip)

    def forward(self, x: torch.Tensor, hf: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform; hf: (B,) highcut bin indices;
        ``generator`` feeds the DropPath and dropout masks in training mode."""
        chan = x.dim() == 3
        if chan:
            x = x[:, 0, :]
        length = x.shape[-1]
        mag, phase = self._mag_phase(x)
        mag_dc, mag = mag[:, :1], mag[:, 1:]
        # The correction in per-sample standardised units (model.py:433-457).
        mean = mag.mean(dim=(-2, -1), keepdim=True)
        std = mag.std(dim=(-2, -1), keepdim=True)  # unbiased, as torch.Tensor.std
        mag = self._corrected(self.core, (mag - mean) / (1e-5 + std), generator) * std + mean
        mag, phase = self._apply_lfr(torch.cat([mag_dc, mag], dim=-2), phase, x, hf, chan)
        wav = self._i_mag_phase(mag, phase)[..., :length]
        return wav[:, None, :] if chan else wav


class DualStreamInteractiveMambaUNet(SpectralUNet):
    """Magnitude and phase streams with additive interactions after every
    encoder and decoder stage (reference model.py:1006-1552). ``interact``:
    dual | p2m | m2p | single.

    ``fuse_streams``: with concat skips and no phase-decoder fix both streams
    run through the magnitude decoder, and each such stage is then one call
    on the batch-concatenated pair (identical per-sample maths; in training
    one mask stream for the pair, as in the JAX package)."""

    INTERACTIONS = ("dual", "p2m", "m2p", "single")

    def __init__(self, interact: str = "dual", phase_decoder_fix: bool = False,
                 fuse_streams: bool = False, concat_skip: bool = True, **kwargs):
        spectral, stream_kwargs = _split_kwargs(kwargs)
        super().__init__(**spectral)
        if interact not in self.INTERACTIONS:
            raise ValueError(f"interact must be one of {self.INTERACTIONS}, got {interact!r}")
        self.interact = interact
        self.phase_decoder_fix = phase_decoder_fix
        self.fuse_streams = fuse_streams
        self.concat_skip = concat_skip
        # The phase decoders run only with the fix or with additive skips.
        self.phase_decoders_used = phase_decoder_fix or not concat_skip
        kw = dict(concat_skip=concat_skip, compute_dtype=self.compute_dtype, **stream_kwargs)
        self.core_mag = self._register_stream(build_stream(**kw), "_mag", concat_skip)
        self.core_phase = None if interact == "single" else self._register_stream(
            build_stream(with_decoders=self.phase_decoders_used, **kw), "_phase", concat_skip)
        self.num_layers = len(self.core_mag.layers_encoder)

    def _interact(self, m, p):
        if self.interact == "dual":
            # Sequential adds: the second uses the updated mag (model.py:1174-1176).
            m = m + p
            p = p + m
        elif self.interact == "p2m":
            m = m + p
        elif self.interact == "m2p":
            p = p + m
        return m, p

    def _decode(self, i: int, m, p, skip, generator):
        """Decoder stage i of both streams, joining ``skip`` (a (mag, phase)
        pair, or None at the standard layout's pass-through stage 0)."""
        # Either the phase decoders or (concat skips, no fix) the mag decoder,
        # which at the pass-through stage 0 is the identity either way.
        phase_core = self.core_phase if self.phase_decoders_used else self.core_mag
        if skip is None:
            return self.core_mag.decode(i, m, generator), phase_core.decode(i, p, generator)
        m, p = self.core_mag.join(m, skip[0]), phase_core.join(p, skip[1])
        if self.fuse_streams and not self.phase_decoders_used:
            return self.core_mag.decode(i, torch.cat([m, p], dim=0), generator).chunk(2, dim=0)
        return self.core_mag.decode(i, m, generator), phase_core.decode(i, p, generator)

    def forward(self, x: torch.Tensor, hf: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform; hf: (B,) highcut bin indices.

        In training mode (``model.train()``) every DropPath and dropout draws
        its mask from ``generator``, a ``torch.Generator`` on x's device (the
        JAX package's ``deterministic=False`` with a "dropout" rng)."""
        chan = x.dim() == 3
        if chan:
            x = x[:, 0, :]
        length = x.shape[-1]
        mag, phase = self._mag_phase(x)
        if self.interact == "single":
            # The whole magnitude U-Net, unnormalised; the phase passes
            # through and only the magnitude's low band is replaced
            # (model.py:1461-1542).
            mag = torch.cat([mag[:, :1], self._corrected(self.core_mag, mag[:, 1:], generator)],
                            dim=-2)
            mag, _ = self._apply_lfr(mag, None, x, hf, chan)
            wav = self._i_mag_phase(mag, phase)[..., :length]
            return wav[:, None, :] if chan else wav

        n = self.num_layers
        latent = self.core_mag.has_latent
        mag_dc, phase_dc = mag[:, :1], phase[:, :1]
        mag, phase = mag[:, 1:], phase[:, 1:]
        residual_mag = mag  # no normalisation (model.py:1113-1116)

        m = self.core_mag.embed(mag[..., None].to(self.compute_dtype))
        p = self.core_phase.embed(phase[..., None].to(self.compute_dtype))
        skips = [(m, p)]
        for i in range(n):
            m = self.core_mag.encode(i, m, generator)
            p = self.core_phase.encode(i, p, generator)
            if latent or i < n - 1:
                skips.append((m, p))
            m, p = self._interact(m, p)
        if latent:
            # The bottleneck: no interaction (model.py:1133-1139).
            m = self.core_mag.run_latent(m, generator)
            p = self.core_phase.run_latent(p, generator)
        for i in range(n):
            skip = skips.pop() if latent or i != 0 else None
            m, p = self._interact(*self._decode(i, m, p, skip, generator))

        ms, ps = skips.pop()
        m = self.core_mag.output(self.core_mag.join(m, ms), generator)
        p = self.core_phase.output(self.core_phase.join(p, ps), generator)

        mag = m[..., 0].float() + residual_mag
        phase = p[..., 0].float()
        mag = torch.cat([mag_dc, mag], dim=-2)
        phase = torch.cat([phase_dc, phase], dim=-2)
        mag, phase = self._apply_lfr(mag, phase, x, hf, chan)

        wav = self._i_mag_phase(mag, phase)[..., :length]
        return wav[:, None, :] if chan else wav


# ---------------------------------------------------------------------------
# Stacked dual-stream execution (JAX package: models/unet.py:618-778)
#
# The dual-stream model runs two same-architecture streams with different
# weights, so one forward launches every op twice, each small; on the card
# the host's launches set the batch-1 forward's wall. Here the two streams
# run as one (2, B, ...) tensor through torch.func.vmap over ONE stream's
# stage modules, whose parameters carry a leading stream axis of 2: each op
# runs once for both streams at identical per-sample maths. The scans'
# batching rules fold the stream axis into the kernels' rows with per-stream
# parameters (ops/selective_scan_fused.py), so each SS2D keeps its own
# routing: stacking the streams on the channel axis instead would double
# K·D and move the narrow heads across the fused kernel's K·D >= 128 gate.
# The scans' rules launch the forward only: the stacked model serves.


class DualStreamStackedMambaUNet(SpectralUNet):
    """Execution-equivalent re-layout of DualStreamInteractiveMambaUNet for
    serving: the magnitude and phase streams run as one stacked (2, B, ...)
    tensor through stream-vmapped stages (embed, encode(i), run_latent,
    decode(i), output) whose parameters have a leading stream axis of 2.

    Its weights come from the unstacked model: ``stack_dual_state`` (or
    ``models.factory.to_stacked``); the reference's phase-through-mag-decoder
    quirk (model.py:1148, PHASE_DECODER_FIX False) is encoded there by
    stacking those decoder stages as [mag, mag]. Module names are one
    stream's without a suffix (``layers_encoder.0...``), as the JAX model's
    ``core``. The parameters need no gradient: the model serves only, in
    eval mode, and a scan under vmap that would need a gradient raises."""

    INTERACTIONS = ("dual", "p2m", "m2p")

    def __init__(self, interact: str = "dual", phase_decoder_fix: bool = False,
                 concat_skip: bool = True, **kwargs):
        spectral, stream_kwargs = _split_kwargs(kwargs)
        super().__init__(**spectral)
        if interact == "single":
            raise ValueError("interact='single' has one stream: use MambaUNet or "
                             "DualStreamInteractiveMambaUNet")
        if interact not in self.INTERACTIONS:
            raise ValueError(f"interact must be one of {self.INTERACTIONS}, got {interact!r}")
        self.interact = interact
        self.phase_decoder_fix = phase_decoder_fix
        self.concat_skip = concat_skip
        self.core = self._register_stream(
            build_stream(concat_skip=concat_skip, compute_dtype=self.compute_dtype,
                         **stream_kwargs), "", concat_skip)
        self.num_layers = len(self.core.layers_encoder)
        for module in self.modules():  # one stream's weights → both streams', (2, ...)
            for name, p in list(module.named_parameters(recurse=False)):
                setattr(module, name, nn.Parameter(p.new_zeros((2, *p.shape)),
                                                   requires_grad=False))

    def _stage(self, module: nn.Module, s: torch.Tensor) -> torch.Tensor:
        """``module`` run once over the stream axis of ``s`` (2, B, ...),
        stream i with slice i of its stacked parameters."""
        params = dict(module.named_parameters())
        return vmap(lambda p, x: functional_call(module, p, (x,)))(params, s)

    def _interact_stacked(self, s):
        m, p = s[0], s[1]
        if self.interact == "dual":
            # Sequential adds: the second uses the updated mag (model.py:1174-1176).
            m = m + p
            p = p + m
        elif self.interact == "p2m":
            m = m + p
        elif self.interact == "m2p":
            p = p + m
        return torch.stack([m, p])

    def forward(self, x: torch.Tensor, hf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform; hf: (B,) highcut bin indices. Eval
        mode only."""
        if self.training:
            raise RuntimeError("the stacked model serves only: call .eval() (train the "
                               "unstacked DualStreamInteractiveMambaUNet)")
        chan = x.dim() == 3
        if chan:
            x = x[:, 0, :]
        length = x.shape[-1]
        core, n = self.core, self.num_layers
        mag, phase = self._mag_phase(x)
        mag_dc, phase_dc = mag[:, :1], phase[:, :1]
        mag, phase = mag[:, 1:], phase[:, 1:]
        residual_mag = mag  # no normalisation (model.py:1113-1116)

        s = self._stage(core.patch_embed,
                        torch.stack([mag, phase])[..., None].to(self.compute_dtype))
        skips = [s]
        for i in range(n):
            s = self._stage(core.layers_encoder[i], s)
            if core.has_latent or i < n - 1:
                skips.append(s)
            s = self._interact_stacked(s)
        if core.has_latent:
            # The bottleneck: no interaction (model.py:1133-1139).
            s = self._stage(core.layers_latent[0], s)
        for i in range(n):
            if core.has_latent or i != 0:
                s = core.join(s, skips.pop())
            s = self._interact_stacked(self._stage(core.layers_decoder[i], s))
        s = self._stage(core.output_layer, core.join(s, skips.pop()))

        mag = torch.cat([mag_dc, s[0, ..., 0].float() + residual_mag], dim=-2)
        phase = torch.cat([phase_dc, s[1, ..., 0].float()], dim=-2)
        mag, phase = self._apply_lfr(mag, phase, x, hf, chan)
        wav = self._i_mag_phase(mag, phase)[..., :length]
        return wav[:, None, :] if chan else wav


def stack_dual_state(state: Dict[str, torch.Tensor], *, concat_skip: bool = True,
                     has_latent: bool = False, phase_decoder_fix: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """A DualStreamInteractiveMambaUNet ``state_dict`` (``*_mag``/``*_phase``
    names) → the DualStreamStackedMambaUNet's (one stream's names, every
    tensor stacked [mag, phase] on a new leading axis): the JAX package's
    ``stack_dual_params`` (models/unet.py:746-778).

    The selection rules mirror the unstacked orchestration: decoder stages
    where the reference routes BOTH streams through the mag decoder
    (concat-skip stages past the standard layout's pass-through stage 0,
    model.py:1148, unless ``phase_decoder_fix``) stack as [mag, mag];
    everything else as [mag, phase]. The phase stream's tensors with no mag
    counterpart do not exist (the model builds no phase decoders there)."""
    out = {}
    for key, mag in state.items():
        head, _, rest = key.partition(".")
        if not head.endswith("_mag"):
            continue
        base = head[:-len("_mag")]
        quirk = False
        if base == "layers_decoder" and concat_skip and not phase_decoder_fix:
            quirk = has_latent or int(rest.split(".", 1)[0]) != 0
        out[f"{base}.{rest}"] = torch.stack([mag, mag if quirk else state[f"{base}_phase.{rest}"]])
    return out
