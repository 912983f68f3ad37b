"""Model factory: config → generator and discriminators (port of
vm_asr_tpu/models/factory.py), config → the VMamba classifier
(MODEL.TYPE "vssm"), and config → the Jamba language model (MODEL.TYPE
"jamba")."""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from ..core.device import resolve_device
from .discriminator import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    StackedMultiPeriodDiscriminator,
)
from .jamba import JambaLM
from .layers import init_parameters
from .unet import (
    DualStreamInteractiveMambaUNet,
    DualStreamStackedMambaUNet,
    MambaUNet,
    stack_dual_state,
)
from .vssm import BackboneVSSM, VSSM

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


# The names the JAX factory builds as MambaUNet (vm_asr_tpu/models/factory.py:87-88).
_MAMBA_UNET_NAMES = ("MambaUNet", "VM_ASR_BASIC")


def _backbone_kwargs(config) -> Dict[str, Any]:
    """The arguments the generator and the classifier share: the patch
    embedding, the stages' widths and depths, every SS2D and block option,
    and the compute dtype."""
    v = config.MODEL.VSSM
    return dict(
        in_chans=v.IN_CHANS,
        patch_size=v.PATCH_SIZE,
        depths=tuple(v.DEPTHS),
        dims=v.DIMS,
        ssm_d_state=v.SSM_D_STATE,
        ssm_ratio=v.SSM_RATIO,
        ssm_dt_rank=v.SSM_DT_RANK,
        ssm_act=v.SSM_ACT_LAYER,
        ssm_conv=v.SSM_CONV,
        ssm_conv_bias=v.SSM_CONV_BIAS,
        ssm_drop_rate=v.SSM_DROP_RATE,
        mlp_ratio=v.MLP_RATIO,
        mlp_act=v.MLP_ACT_LAYER,
        mlp_drop_rate=v.MLP_DROP_RATE,
        gmlp=bool(v.GMLP),
        drop_path_rate=v.DROP_PATH_RATE,
        patch_norm=v.PATCH_NORM,
        patchembed_version=v.PATCHEMBED,
        use_checkpoint=bool(v.get("USE_CHECKPOINT", False)),
        compute_dtype=_DTYPES[config.DTYPE.COMPUTE] if config.AMP_ENABLE else torch.float32,
        scan_fp32_io=bool(v.get("SCAN_FP32_IO", False)),
    )


def generator_kwargs(config) -> Dict[str, Any]:
    """Constructor arguments of the generator named by ``config``: every
    MODEL.VSSM option the JAX factory passes (vm_asr_tpu/models/factory.py:
    25-58, 79-88). STACKED_EXECUTION is not one: it swaps the trained model
    for its stacked twin at serving time (``to_stacked``)."""
    v = config.MODEL.VSSM
    name = config.MODEL.NAME
    if name not in ("DualStreamInteractiveMambaUNet",) + _MAMBA_UNET_NAMES:
        raise ValueError(f"Unknown model name: {name}")
    kwargs = dict(
        _backbone_kwargs(config),
        output_version=v.OUTPUT,
        concat_skip=v.CONCAT_SKIP,
        n_fft=config.DATA.STFT.N_FFT,
        hop_length=config.DATA.STFT.HOP_LENGTH,
        win_length=config.DATA.STFT.WIN_LENGTH,
        spectro_scale=config.DATA.STFT.SCALE,
        low_freq_replacement=config.TRAIN.LOW_FREQ_REPLACEMENT,
        lfr_mode=config.TRAIN.get("LFR_MODE", "torch"),
    )
    if name == "DualStreamInteractiveMambaUNet":
        kwargs.update(interact=v.INTERACT,
                      phase_decoder_fix=bool(v.get("PHASE_DECODER_FIX", False)),
                      fuse_streams=bool(v.get("FUSE_STREAMS", False)))
    return kwargs


def get_generator(config, device="cuda", seed=None
                  ) -> Union[DualStreamInteractiveMambaUNet, MambaUNet]:
    """The generator of ``config`` in eval mode on ``device``: a
    ``DualStreamInteractiveMambaUNet`` for that MODEL.NAME, a ``MambaUNet``
    for "MambaUNet" and "VM_ASR_BASIC" (the config's default), initialised
    from a ``torch.Generator`` seeded with ``seed`` (default ``config.SEED``).

    ``device`` defaults to the card; a CUDA device without CUDA raises."""
    cls = MambaUNet if config.MODEL.NAME in _MAMBA_UNET_NAMES \
        else DualStreamInteractiveMambaUNet
    return _build(cls, generator_kwargs(config), config.SEED if seed is None else seed,
                  device)


def get_vssm(device="cuda", seed: int = 0, cls: type = VSSM, **kwargs
             ) -> Union[VSSM, BackboneVSSM]:
    """``cls(**kwargs)``, the VMamba classifier ``VSSM`` or its multi-scale
    feature backbone ``BackboneVSSM``, in eval mode on ``device``,
    initialised from a ``torch.Generator`` seeded with ``seed``. ``device``
    defaults to the card; a CUDA device without CUDA raises."""
    return _build(cls, kwargs, seed, device)


def classifier_kwargs(config) -> Dict[str, Any]:
    """Constructor arguments of the VMamba classifier ``VSSM`` named by a
    configuration of MODEL.TYPE "vssm" (VMamba's classification configs,
    MzeroMiko/VMamba classification/config.py): MODEL.NUM_CLASSES and the
    MODEL.VSSM keys the generator reads too; DIMS is the embedding width
    (VMamba's EMBED_DIM). The stages merge by the published v1 downsample
    (the Swin 2×2 merge), the only one built; another raises."""
    if config.MODEL.TYPE != "vssm":
        raise ValueError(f"not a classifier configuration: MODEL.TYPE {config.MODEL.TYPE!r}")
    if config.MODEL.VSSM.DOWNSAMPLE != "v1":
        raise ValueError(f"the classifier downsamples by the v1 merge, not "
                         f"{config.MODEL.VSSM.DOWNSAMPLE!r}")
    return dict(_backbone_kwargs(config), num_classes=config.MODEL.NUM_CLASSES)


def build_classifier(config, device="cuda", seed=None) -> VSSM:
    """The VMamba classifier of ``config`` (MODEL.TYPE "vssm") in eval mode
    on ``device``, initialised from a ``torch.Generator`` seeded with
    ``seed`` (default ``config.SEED``). ``device`` defaults to the card; a
    CUDA device without CUDA raises."""
    return _build(VSSM, classifier_kwargs(config), config.SEED if seed is None else seed,
                  device)


def language_model_kwargs(config) -> Dict[str, Any]:
    """Constructor arguments of ``JambaLM`` named by a configuration of
    MODEL.TYPE "jamba": the MODEL.JAMBA keys, which are the published
    config.json's, and the compute dtype. The port builds tied embeddings
    only; untied ones raise."""
    if config.MODEL.TYPE != "jamba":
        raise ValueError(f"not a language model configuration: MODEL.TYPE {config.MODEL.TYPE!r}")
    j = config.MODEL.JAMBA
    if not j.TIE_WORD_EMBEDDINGS:
        raise ValueError("the port builds Jamba with tied embeddings only")
    return dict(
        vocab_size=j.VOCAB_SIZE, hidden_size=j.HIDDEN_SIZE, num_hidden_layers=j.NUM_HIDDEN_LAYERS,
        num_attention_heads=j.NUM_ATTENTION_HEADS, num_key_value_heads=j.NUM_KEY_VALUE_HEADS,
        intermediate_size=j.INTERMEDIATE_SIZE, attn_layer_period=j.ATTN_LAYER_PERIOD,
        attn_layer_offset=j.ATTN_LAYER_OFFSET, mamba_d_state=j.MAMBA_D_STATE,
        mamba_d_conv=j.MAMBA_D_CONV, mamba_expand=j.MAMBA_EXPAND, mamba_dt_rank=j.MAMBA_DT_RANK,
        mamba_conv_bias=bool(j.MAMBA_CONV_BIAS), mamba_proj_bias=bool(j.MAMBA_PROJ_BIAS),
        rms_norm_eps=j.RMS_NORM_EPS,
        compute_dtype=_DTYPES[config.DTYPE.COMPUTE] if config.AMP_ENABLE else torch.float32,
    )


def build_language_model(config, device="cuda", seed=None) -> JambaLM:
    """The Jamba language model of ``config`` (MODEL.TYPE "jamba") in eval
    mode on ``device``, built on the meta device, initialised on ``device``
    from a generator seeded with ``seed`` (default ``config.SEED``; 3 G
    parameters at the published sizes, which the CPU would take minutes to
    draw), its matrices made in DTYPE.PARAMS and ``A_log``, ``D`` and Δ's
    bias in fp32. ``device`` defaults to the card; a CUDA device without CUDA
    raises."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = JambaLM(**language_model_kwargs(config)).cast_params(_DTYPES[config.DTYPE.PARAMS])
    model = model.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(config.SEED if seed is None else seed))
    init_parameters(model, gen)
    return model.eval()


def _build(cls: type, kwargs: Dict[str, Any], seed: int, device) -> torch.nn.Module:
    """``cls(**kwargs)`` built on the meta device, initialised on the CPU
    from a generator seeded with ``seed``, then moved to ``device``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = cls(**kwargs)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def to_stacked(config, generator: torch.nn.Module) -> torch.nn.Module:
    """Serving path: the stream-stacked execution model
    (``DualStreamStackedMambaUNet``: each op once for both streams, identical
    outputs) with ``generator``'s weights, in eval mode on its device; the
    JAX package's ``to_stacked`` (vm_asr_tpu/models/factory.py:128-155).
    Returns ``generator`` itself unless the config sets
    MODEL.VSSM.STACKED_EXECUTION, the model is the dual-stream U-Net and
    ``interact`` is not "single" (or when it is stacked already). Training
    keeps the unstacked model, as the JAX Trainer does; checkpoints stay in
    its layout."""
    v = config.MODEL.VSSM
    if not bool(v.get("STACKED_EXECUTION", False)) or \
            config.MODEL.NAME != "DualStreamInteractiveMambaUNet" or v.INTERACT == "single" \
            or not isinstance(generator, DualStreamInteractiveMambaUNet):
        return generator
    kwargs = generator_kwargs(config)
    kwargs.pop("fuse_streams")  # stacking runs every stage once for both streams anyway
    with torch.device("meta"):
        stacked = DualStreamStackedMambaUNet(**kwargs)
    dims, depths = v.DIMS, list(v.DEPTHS)
    state = stack_dual_state(
        generator.state_dict(), concat_skip=bool(v.CONCAT_SKIP),
        has_latent=not isinstance(dims, int) and len(dims) == len(depths) + 1,
        phase_decoder_fix=bool(v.get("PHASE_DECODER_FIX", False)))
    stacked.load_state_dict(state, assign=True)
    return stacked.requires_grad_(False).eval()


def get_discriminators(config, device="cuda", seed=None) -> Dict[str, torch.nn.Module]:
    """The discriminators of TRAIN.ADVERSARIAL.DISCRIMINATORS when the config
    trains adversarially, else {}: "mpd" (the StackedMultiPeriodDiscriminator
    with MPD_STACKED, its periods grouped by MPD_STACK_GROUPS) and "msd"
    (MSD_HIDDEN), as the JAX factory builds them
    (vm_asr_tpu/models/factory.py:95-125). Initialised in name order from one
    ``torch.Generator`` seeded with ``seed`` (default ``config.SEED + 1``,
    apart from the generator's draws) and placed on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    adv = config.TRAIN.ADVERSARIAL
    if not adv.ENABLE:
        return {}
    unknown = [n for n in adv.DISCRIMINATORS if n not in ("mpd", "msd", "")]
    if unknown:
        raise ValueError(f"unknown discriminators {unknown}")
    compute = _DTYPES[config.DTYPE.COMPUTE] if config.AMP_ENABLE else torch.float32
    models: Dict[str, torch.nn.Module] = {}
    if "mpd" in adv.DISCRIMINATORS:
        periods = tuple(adv.get("MPD_PERIODS", [2, 3, 5, 7, 11]))
        if bool(adv.get("MPD_STACKED", False)):
            models["mpd"] = StackedMultiPeriodDiscriminator(
                hidden=adv.MPD_HIDDEN, periods=periods,
                groups=adv.get("MPD_STACK_GROUPS", []) or None, compute_dtype=compute)
        else:
            models["mpd"] = MultiPeriodDiscriminator(hidden=adv.MPD_HIDDEN, periods=periods,
                                                     compute_dtype=compute)
    if "msd" in adv.DISCRIMINATORS:
        models["msd"] = MultiScaleDiscriminator(hidden=adv.get("MSD_HIDDEN", 128),
                                                compute_dtype=compute)
    gen = torch.Generator().manual_seed(int(config.SEED + 1 if seed is None else seed))
    for name in sorted(models):
        init_parameters(models[name], gen)
    return {name: m.to(dev) for name, m in models.items()}


def set_scan_impl(model: torch.nn.Module, impl: str) -> None:
    """Route every SS2D of ``model`` to the scan kernels ("kernel") or to
    their plain versions ("plain")."""
    from ..ops.scan_api import IMPLS
    from .ss2d import SS2D

    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    for m in model.modules():
        if isinstance(m, SS2D):
            m.scan_impl = impl
