from .discriminator import MultiPeriodDiscriminator, PeriodDiscriminator, SpectralNormConv2d
from .factory import generator_kwargs, get_discriminators, get_generator, set_scan_impl
from .layers import (
    ConvTranspose2d,
    DropPath,
    Dropout,
    GMlp,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    PatchExpanding,
    PatchMerging,
    init_parameters,
)
from .ss2d import SS2D
from .unet import DualStreamInteractiveMambaUNet, MambaUNet, SpectralUNet, UNetCore
from .vss import VSSBlock, VSSLayer

__all__ = [
    "ConvTranspose2d",
    "DropPath",
    "Dropout",
    "DualStreamInteractiveMambaUNet",
    "GMlp",
    "LayerNorm",
    "Linear",
    "MambaUNet",
    "Mlp",
    "MultiPeriodDiscriminator",
    "PatchEmbed",
    "PatchExpanding",
    "PatchMerging",
    "PeriodDiscriminator",
    "SS2D",
    "SpectralNormConv2d",
    "SpectralUNet",
    "UNetCore",
    "VSSBlock",
    "VSSLayer",
    "generator_kwargs",
    "get_discriminators",
    "get_generator",
    "init_parameters",
    "set_scan_impl",
]
