"""Weights between the JAX package's flax tree and the port.

The port's ``state_dict`` keys are the reference's names, so
``flax_params_to_state_dict`` is the inverse of
``vm_asr_tpu.compat.torch_port.state_dict_to_flax`` (whose name map,
torch_port.py:10-28, this follows in reverse), and reference
``*best*G*.pth`` checkpoints load with ``load_state_dict`` directly
(``load_reference_checkpoint``).

Layout transforms (flax → torch):

    Dense kernel (in, out)              → Linear weight (out, in)
    Dense kernel of a 1×1 conv (in, out) → Conv2d weight (out, in, 1, 1)
    Conv kernel (kh, kw, in/g, out)     → Conv2d weight (out, in/g, kh, kw)
    ConvTranspose kernel (kh, kw, in, out) → ConvTranspose2d weight
                                          (in, out, kh, kw), flipped in kh and kw
    LayerNorm scale                     → weight
    A_logs (K, D, N) / Ds (K, D)        → (K·D, N) / (K·D,)
    x_proj_weight / dt_projs_weight / dt_projs_bias → verbatim
"""

from __future__ import annotations

import pickle
import re
import warnings
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_STREAMS = {"core": "", "core_mag": "_mag", "core_phase": "_phase"}
# v2/v3 heads: the reference's Sequential slots. The v1 head keeps the JAX
# package's names (models/unet.py:HeadV1).
_OUTPUT = {"out_vss1": "0", "out_vss2": "1", "out_conv": "3", "out_vss3": "5",
           "out_skip_conv": "out_skip_conv", "out_convt1": "out_convt1",
           "out_convt2": "out_convt2"}
# v2: conv1/norm1/conv2/norm2; v1: proj/norm (reference model.py:580-633).
_PATCH_EMBED = {"conv1": "0", "norm1": "2", "conv2": "5", "norm2": "7", "proj": "0", "norm": "2"}
_CONV_1X1 = ("skip_conv", "out_conv", "out_skip_conv")
_CONV_TRANSPOSE = ("out_convt1", "out_convt2")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(path: Tuple[str, ...], value: np.ndarray):
    """(module path, flax leaf) → (torch leaf name, array)."""
    *mods, leaf = path
    owner = mods[-1] if mods else ""
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        return "bias", value
    if leaf == "kernel":
        if owner in _CONV_1X1:
            return "weight", value.T[:, :, None, None]
        if owner in _CONV_TRANSPOSE:  # flax's transposed conv does not flip
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
        if value.ndim == 4:  # conv (kh, kw, in/g, out)
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if leaf == "A_logs":
        return "A_logs", value.reshape(-1, value.shape[-1])
    if leaf == "Ds":
        return "Ds", value.reshape(-1)
    if leaf in ("x_proj_weight", "dt_projs_weight", "dt_projs_bias"):
        return leaf, value
    raise KeyError(f"unknown flax leaf {'/'.join(path)}")


def _module_name(mods: Tuple[str, ...]) -> str:
    """flax module path (below a stream root) → the reference's dotted path."""
    out = []
    for i, m in enumerate(mods):
        stage = re.fullmatch(r"(encoders|decoders|blocks|stages|out_norms)_(\d+)", m)
        if stage:
            kind, idx = stage.groups()
            out.append({"encoders": "layers_encoder", "decoders": "layers_decoder"}
                       .get(kind, kind) + f".{idx}")
        elif m == "latent":
            out.append("layers_latent.0")
        elif m == "skip_conv":
            out.append("skip_handler.1")
        elif m in _OUTPUT:
            out.append(f"output_layer.{_OUTPUT[m]}")
        elif m in _PATCH_EMBED and i > 0 and mods[i - 1] == "patch_embed":
            out[-1] = f"patch_embed.{_PATCH_EMBED[m]}"
        else:
            out.append(m)
    return ".".join(out)


def _with_stream_suffix(name: str, sfx: str) -> str:
    head, _, rest = name.partition(".")
    return f"{head}{sfx}.{rest}" if rest else f"{head}{sfx}"


def flax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax params tree (nested dict of arrays) → torch ``state_dict``.

    Takes a whole generator tree ({core_mag, core_phase}, {core_mag} of a
    single-stream dual model, or {core} of a MambaUNet) or the tree of one
    SS2D / VSSBlock / VSSLayer, whose keys then come out relative to that
    module. Maps both layouts (the latent stage to ``layers_latent.0``), both
    patch embeds and the three heads.

    Also takes the tree of a ``VSSM`` or ``BackboneVSSM`` (models/vssm.py):
    ``stages_{i}`` → ``stages.{i}``, ``out_norms_{t}`` → ``out_norms.{t}``;
    ``patch_embed``, ``norm`` and ``head`` keep their names. The JAX package
    maps only the U-Net onto the reference's names (compat/torch_port.py),
    so these keys are the JAX tree's; the reference VMamba's own names are
    not checked here.
    """
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        root = path[0] if path[0] in _STREAMS else None
        mods = path[1:-1] if root else path[:-1]
        leaf, arr = _leaf(path, value)
        name = _module_name(tuple(mods))
        if root:
            name = _with_stream_suffix(name, _STREAMS[root])
        key = f"{name}.{leaf}" if name else leaf
        if key in out:
            raise KeyError(f"duplicate mapping for {'/'.join(path)} → {key}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return out


def flax_disc_variables_to_state_dict(variables: Mapping, periods=None,
                                      groups=None) -> Dict[str, torch.Tensor]:
    """A flax discriminator's variables tree ({"params", "batch_stats"}) →
    the port's ``state_dict``, for the MultiPeriodDiscriminator, the
    MultiScaleDiscriminator and the StackedMultiPeriodDiscriminator:

        params/disc_i/conv_j/kernel (kh, kw, I, O) or (k, I/g, O)
            → discriminators.i.convs.j.weight (O, I, kh, kw) or (O, I/g, k)
        params/disc_i/conv_j/bias → discriminators.i.convs.j.bias
        batch_stats/disc_i/SpectralNorm_m/"conv_j/kernel/u" (1, O) → ….convs.j.u
        batch_stats/disc_i/SpectralNorm_m/"conv_j/kernel/sigma" () → ….convs.j.sigma

    and the same for ``conv_post``. A stacked MPD's ``group_g`` subtrees
    (every leaf with a leading lane axis) are unstacked with
    ``models.discriminator.unstack_mpd_state`` over ``periods`` and
    ``groups`` (MPD_PERIODS, MPD_STACK_GROUPS), so the result is always the
    unstacked layout that the port's modules and ``.pth`` files keep."""

    def layer(disc: str, conv: str) -> str:
        i = re.fullmatch(r"(disc|group)_(\d+)", disc)
        j = re.fullmatch(r"conv_(\d+)", conv)
        if i is None or (j is None and conv != "conv_post"):
            raise KeyError(f"unknown discriminator layer {disc}/{conv}")
        root = f"discriminators.{i.group(2)}" if i.group(1) == "disc" else f"group_{i.group(2)}"
        return f"{root}." + (f"convs.{j.group(1)}" if j else "conv_post")

    def weight(disc: str, kernel: np.ndarray) -> np.ndarray:
        """flax (*k, I, O) → torch (O, I, *k), after a stacked lane axis."""
        lead = 1 if disc.startswith("group_") else 0
        spatial = tuple(range(lead, kernel.ndim - 2))
        return kernel.transpose(tuple(range(lead)) + (kernel.ndim - 1, kernel.ndim - 2) + spatial)

    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(variables["params"]):
        disc, conv, leaf = path
        name = "weight" if leaf == "kernel" else leaf
        out[f"{layer(disc, conv)}.{name}"] = weight(disc, value) if leaf == "kernel" else value
    for path, value in _flatten(variables.get("batch_stats", {})):
        disc, _sn, key = path
        conv, kernel, leaf = key.split("/")
        if kernel != "kernel" or leaf not in ("u", "sigma"):
            raise KeyError(f"unknown discriminator statistic {'/'.join(path)}")
        out[f"{layer(disc, conv)}.{leaf}"] = value
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
             for k, v in out.items()}
    if any(k.startswith("group_") for k in state):
        if periods is None:
            raise ValueError("a stacked MPD's variables need its periods (and groups)")
        from ..models.discriminator import unstack_mpd_state

        state = {k: v.clone() for k, v in unstack_mpd_state(state, periods, groups).items()}
    return state


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference generator checkpoint (``*best*G*.pth``: the
    state_dict itself or {state_dict, ...}) into ``model`` by name.

    ``layers_decoder_phase.*`` is dropped when the model has no phase
    decoders (they are dead weights in every reference checkpoint; see
    models/unet.py). The safe ``weights_only`` loader is tried first; a file
    that pickles other objects (the reference embeds its config) is then
    unpickled in full, which runs code from the file: load only checkpoints
    you trust."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(
            f"{path}: not loadable with weights_only=True; falling back to full "
            "unpickling, which can execute arbitrary code from the checkpoint "
            "file. Only do this with checkpoints you trust.",
            stacklevel=2,
        )
        blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["state_dict"] if isinstance(blob, dict) and "state_dict" in blob else blob
    own = model.state_dict()
    if not any(k.startswith("layers_decoder_phase.") for k in own):
        sd = {k: v for k, v in sd.items() if not k.startswith("layers_decoder_phase.")}
    model.load_state_dict(sd, strict=True)
