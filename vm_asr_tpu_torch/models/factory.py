"""Model factory: config → generator (port of the generator part of
vm_asr_tpu/models/factory.py)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.device import resolve_device
from .layers import init_parameters
from .unet import DualStreamInteractiveMambaUNet

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def generator_kwargs(config) -> Dict[str, Any]:
    """Constructor arguments of the generator named by ``config``; raises for
    the options the port does not have yet."""
    v = config.MODEL.VSSM
    if config.MODEL.NAME != "DualStreamInteractiveMambaUNet":
        raise NotImplementedError(
            f"MODEL.NAME {config.MODEL.NAME}: only DualStreamInteractiveMambaUNet is ported"
        )
    unported = {
        "MODEL.VSSM.GMLP": bool(v.GMLP),
        "MODEL.VSSM.FUSE_STREAMS": bool(v.get("FUSE_STREAMS", False)),
        "MODEL.VSSM.STACKED_EXECUTION": bool(v.get("STACKED_EXECUTION", False)),
    }
    on = [k for k, flag in unported.items() if flag]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")
    compute = _DTYPES[config.DTYPE.COMPUTE] if config.AMP_ENABLE else torch.float32
    return dict(
        interact=v.INTERACT,
        phase_decoder_fix=bool(v.get("PHASE_DECODER_FIX", False)),
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
        mlp_ratio=v.MLP_RATIO,
        mlp_act=v.MLP_ACT_LAYER,
        drop_path_rate=v.DROP_PATH_RATE,
        patch_norm=v.PATCH_NORM,
        patchembed_version=v.PATCHEMBED,
        output_version=v.OUTPUT,
        concat_skip=v.CONCAT_SKIP,
        n_fft=config.DATA.STFT.N_FFT,
        hop_length=config.DATA.STFT.HOP_LENGTH,
        win_length=config.DATA.STFT.WIN_LENGTH,
        spectro_scale=config.DATA.STFT.SCALE,
        low_freq_replacement=config.TRAIN.LOW_FREQ_REPLACEMENT,
        lfr_mode=config.TRAIN.get("LFR_MODE", "torch"),
        compute_dtype=compute,
        scan_fp32_io=bool(v.get("SCAN_FP32_IO", False)),
    )


def get_generator(config, device="cuda", seed=None) -> DualStreamInteractiveMambaUNet:
    """The generator of ``config`` in eval mode on ``device``, initialised from
    a ``torch.Generator`` seeded with ``seed`` (default ``config.SEED``).

    ``device`` defaults to the card; a CUDA device without CUDA raises."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DualStreamInteractiveMambaUNet(**generator_kwargs(config))
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(int(config.SEED if seed is None else seed))
    init_parameters(model, gen)
    return model.to(dev).eval()


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
