"""MambaUNet base and DualStreamInteractiveMambaUNet (port of
vm_asr_tpu/models/unet.py; reference model/model.py:119-1552).

waveform → STFT (513×F) → drop the DC bin (512×F) → patch embed (4× down)
→ 4 encoder stages with PatchMerging → 4 decoder stages with PatchExpanding
and concat skips → v3 output head → + residual magnitude → re-attach DC
→ iSTFT. Channels-last (NHWC) throughout, as in the JAX package.

Kept from the reference, as the JAX package keeps them:
- The first decoder stage receives the empty drop-path slice ``dpr[8:8]``:
  no blocks, no sampler, a pass-through.
- In concat-skip mode the phase stream runs through the *magnitude*
  decoder (model.py:1148) unless ``phase_decoder_fix``; the phase decoders
  are then never built, and a reference checkpoint's
  ``layers_decoder_phase.*`` is dropped on load.
- The dual-stream forward does not normalise the magnitude.
- The "dual" interaction is two sequential adds.
- LOW_FREQ_REPLACEMENT in "torch" mode is a no-op on (B, 1, T) input.

Not ported yet: the latent (5-dims) variant, the v1/v2 heads, the
p2m/m2p/single interactions, FUSE_STREAMS and stacked execution.

Module names are the reference's (``patch_embed_mag``,
``layers_encoder_mag``, ``layers_decoder_mag``, ``output_layer_mag`` and the
``_phase`` twins), so its ``state_dict`` keys are too.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..dsp import spectro2wav, wav2spectro
from .layers import Conv1x1, PatchEmbed
from .vss import VSSLayer


def resolve_dims(dims, num_layers: int) -> List[int]:
    if isinstance(dims, int):
        return [dims * 2**i for i in range(num_layers)]
    return list(dims)


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
    stream suffix): patch_embed, layers_encoder, layers_decoder (when
    ``with_decoders``) and output_layer."""
    num_layers = len(depths)
    dims = resolve_dims(dims, num_layers)
    if len(dims) != num_layers:
        raise NotImplementedError(
            f"dims {dims}: only the standard {num_layers}-entry layout is ported "
            "(the latent variant is not)"
        )
    if output_version != "v3":
        raise NotImplementedError(f"output head {output_version}: only v3 is ported")
    dpr = list(np.linspace(0.0, drop_path_rate, sum(depths)))
    common = dict(compute_dtype=compute_dtype, **block_kwargs)

    def stage(lo, hi):
        return dpr[sum(depths[:lo]):sum(depths[:hi])]

    modules = {
        "patch_embed": PatchEmbed(in_chans, dims[0], patch_size, patchembed_version,
                                  patch_norm, compute_dtype=compute_dtype),
        # Blocks at dims[i]; downsample at every stage end but the last
        # (reference model.py:247-297).
        "layers_encoder": nn.ModuleList(
            VSSLayer(dims[i], stage(i, i + 1),
                     sampler=("merge", dims[i + 1]) if i < num_layers - 1 else None,
                     **common)
            for i in range(num_layers)
        ),
    }
    if with_decoders:
        # i_layer = num_layers .. 1 (reference model.py:338-394).
        decoders = []
        for i_layer in range(num_layers, 0, -1):
            dim = dims[i_layer] if i_layer < num_layers - 1 else dims[num_layers - 1]
            inner = i_layer < num_layers
            decoders.append(VSSLayer(
                dim, stage(i_layer, i_layer + 1),
                sampler=("expand", True) if inner else None,
                concat_skip=concat_skip and inner, **common,
            ))
        modules["layers_decoder"] = nn.ModuleList(decoders)
    # v3 head: VSS(dim0, identity norm, concat skip, expand+LN) → VSS(dim0/2,
    # LN, expand+LN) → 1×1 conv → VSS(in_chans, identity norm), in Sequential
    # slots 0/1/3/5 as in the reference (model.py:773-887).
    dim0 = dims[0]
    modules["output_layer"] = nn.Sequential(
        VSSLayer(dim0, dpr[-1:], use_norm=False, sampler=("expand", True),
                 concat_skip=concat_skip, **common),
        VSSLayer(dim0 // 2, dpr[-1:], use_norm=True, sampler=("expand", True), **common),
        nn.Identity(),
        Conv1x1(dim0 // 4, in_chans, compute_dtype=compute_dtype),
        nn.Identity(),
        VSSLayer(in_chans, dpr[-1:], use_norm=False, **common),
    )
    return modules


class UNetCore:
    """One stream's stage functions over modules its owner registers
    (JAX package: models/unet.py:UNetCore)."""

    def __init__(self, patch_embed, layers_encoder, layers_decoder, output_layer):
        self.patch_embed = patch_embed
        self.layers_encoder = layers_encoder
        self.layers_decoder = layers_decoder
        self.output_layer = output_layer

    def embed(self, x):
        return self.patch_embed(x)

    def encode(self, i: int, x, generator=None):
        return self.layers_encoder[i](x, generator)

    def decode(self, i: int, x, generator=None):
        return self.layers_decoder[i](x, generator)

    def output(self, x, generator=None):
        head = self.output_layer
        return head[5](head[3](head[1](head[0](x, generator), generator)), generator)


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


class MambaUNet(nn.Module):
    """Base of the spectral U-Nets: waveform ↔ (log2-magnitude, phase) images
    and the low-frequency replacement. The single-stream forward is not
    ported yet."""

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


class DualStreamInteractiveMambaUNet(MambaUNet):
    """Magnitude and phase streams with additive interactions after every
    stage (reference model.py:1006-1552); ``interact="dual"`` only."""

    def __init__(self, interact: str = "dual", phase_decoder_fix: bool = False,
                 depths: Sequence[int] = (2, 2, 2, 2), concat_skip: bool = True,
                 n_fft: int = 1024, hop_length: int = 240, win_length: int = 1024,
                 spectro_scale: str = "log2", low_freq_replacement: bool = False,
                 lfr_mode: str = "torch", compute_dtype: torch.dtype = torch.float32,
                 **stream_kwargs):
        super().__init__(n_fft, hop_length, win_length, spectro_scale,
                         low_freq_replacement, lfr_mode, compute_dtype)
        if interact != "dual":
            raise NotImplementedError(f"interact={interact!r}: only 'dual' is ported")
        self.interact = interact
        self.phase_decoder_fix = phase_decoder_fix
        self.concat_skip = concat_skip
        self.num_layers = len(depths)
        # The phase decoders run only with the fix or with additive skips.
        self.phase_decoders_used = phase_decoder_fix or not concat_skip
        kw = dict(depths=depths, concat_skip=concat_skip, compute_dtype=compute_dtype,
                  **stream_kwargs)
        streams = {"mag": build_stream(**kw),
                   "phase": build_stream(with_decoders=self.phase_decoders_used, **kw)}
        for sfx, mods in streams.items():
            for name, module in mods.items():
                self.add_module(f"{name}_{sfx}", module)
        self.core_mag = UNetCore(**streams["mag"])
        self.core_phase = UNetCore(**{"layers_decoder": None, **streams["phase"]})

    @staticmethod
    def _interact(m, p):
        # Sequential adds: the second uses the updated mag (model.py:1174-1176).
        m = m + p
        p = p + m
        return m, p

    def forward(self, x: torch.Tensor, hf: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T) or (B, 1, T) waveform; hf: (B,) highcut bin indices.

        In training mode (``model.train()``) every DropPath draws its mask
        from ``generator``, a ``torch.Generator`` on x's device (the JAX
        package's ``deterministic=False`` with a "dropout" rng)."""
        chan = x.dim() == 3
        if chan:
            x = x[:, 0, :]
        length = x.shape[-1]
        n = self.num_layers

        mag, phase = self._mag_phase(x)
        mag_dc, phase_dc = mag[:, :1], phase[:, :1]
        mag, phase = mag[:, 1:], phase[:, 1:]
        residual_mag = mag  # no normalisation (model.py:1113-1116)

        m = self.core_mag.embed(mag[..., None].to(self.compute_dtype))
        p = self.core_phase.embed(phase[..., None].to(self.compute_dtype))
        skips = [(m, p)]
        for i in range(n):
            m = self.core_mag.encode(i, m, generator)
            p = self.core_phase.encode(i, p, generator)
            if i < n - 1:
                skips.append((m, p))
            m, p = self._interact(m, p)

        # Decoder 0 is a pass-through, so either stream's serves stage 0.
        phase_core = self.core_phase if self.phase_decoders_used else self.core_mag
        for i in range(n):
            if i != 0:
                ms, ps = skips.pop()
                if self.concat_skip:
                    m, p = torch.cat([m, ms], dim=-1), torch.cat([p, ps], dim=-1)
                else:
                    m, p = m + ms, p + ps
            m = self.core_mag.decode(i, m, generator)
            p = phase_core.decode(i, p, generator)
            m, p = self._interact(m, p)

        ms, ps = skips.pop()
        if self.concat_skip:
            m, p = torch.cat([m, ms], dim=-1), torch.cat([p, ps], dim=-1)
        else:
            m, p = m + ms, p + ps
        m = self.core_mag.output(m, generator)
        p = self.core_phase.output(p, generator)

        mag = m[..., 0].float() + residual_mag
        phase = p[..., 0].float()
        mag = torch.cat([mag_dc, mag], dim=-2)
        phase = torch.cat([phase_dc, phase], dim=-2)
        mag, phase = self._apply_lfr(mag, phase, x, hf, chan)

        wav = self._i_mag_phase(mag, phase)[..., :length]
        return wav[:, None, :] if chan else wav
