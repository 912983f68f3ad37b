from .pipeline import (
    Batch,
    DataPipeline,
    DegradingSampler,
    batch_to_device,
    get_loaders,
    train_valid_split,
)
from .vctk import SyntheticVCTK, VCTKDataset, load_wav, parse_silence_labels, save_wav, trim_silence

__all__ = [
    "Batch",
    "DataPipeline",
    "DegradingSampler",
    "SyntheticVCTK",
    "VCTKDataset",
    "batch_to_device",
    "get_loaders",
    "load_wav",
    "parse_silence_labels",
    "save_wav",
    "train_valid_split",
    "trim_silence",
]
