from .factory import generator_kwargs, get_generator, set_scan_impl
from .layers import (
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    PatchEmbed,
    PatchExpanding,
    PatchMerging,
    init_parameters,
)
from .ss2d import SS2D
from .unet import DualStreamInteractiveMambaUNet, MambaUNet, UNetCore
from .vss import VSSBlock, VSSLayer

__all__ = [
    "DropPath",
    "DualStreamInteractiveMambaUNet",
    "LayerNorm",
    "Linear",
    "MambaUNet",
    "Mlp",
    "PatchEmbed",
    "PatchExpanding",
    "PatchMerging",
    "SS2D",
    "UNetCore",
    "VSSBlock",
    "VSSLayer",
    "generator_kwargs",
    "get_generator",
    "init_parameters",
    "set_scan_impl",
]
