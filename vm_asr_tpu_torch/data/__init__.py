from .pipeline import (
    Batch,
    DataPipeline,
    DegradingSampler,
    batch_to_device,
    get_loaders,
    train_valid_split,
)
from .vctk import (
    EXCLUDED_SPEAKERS,
    SyntheticVCTK,
    VCTKDataset,
    convert_flac_corpus,
    load_wav,
    parse_silence_labels,
    save_wav,
    trim_silence,
)
from .worker_pipeline import WorkerPipeline

__all__ = [
    "Batch",
    "DataPipeline",
    "DegradingSampler",
    "EXCLUDED_SPEAKERS",
    "SyntheticVCTK",
    "VCTKDataset",
    "WorkerPipeline",
    "batch_to_device",
    "convert_flac_corpus",
    "get_loaders",
    "load_wav",
    "parse_silence_labels",
    "save_wav",
    "train_valid_split",
    "trim_silence",
]
