"""Hierarchical configuration system: the port's own copy of
vm_asr_tpu/core/config.py.

A lightweight re-implementation of the reference's yacs-based config
(reference: config.py:5-249 for the schema, config.py:252-334 for the
YAML/`BASE:` merge + CLI override + derived-update semantics). The YAML files
in `configs/` parse 1:1 against this schema, which keeps every key of the JAX
package's, including those only its training and TPU paths read. PyYAML is
imported only where a YAML file or value is parsed, so the schema itself needs
nothing beyond the standard library.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable, List, Optional


class CfgNode(dict):
    """An attribute-accessible dict with freeze semantics (yacs-compatible subset)."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Optional[dict] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def _is_frozen(self) -> bool:
        # Tolerate a missing flag: dict-subclass unpickling restores items
        # before instance attributes exist (grain worker processes pickle
        # configs inside transforms).
        try:
            return object.__getattribute__(self, "_frozen")
        except AttributeError:
            return False

    def __setattr__(self, name: str, value: Any) -> None:
        if self._is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key, value):
        if self._is_frozen():
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    def __reduce__(self):
        # Rebuild from the plain-dict form (re-wraps nested CfgNodes);
        # freeze state intentionally does not survive pickling.
        return (CfgNode, (self.to_dict(),))

    # -- freeze / clone ------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def clone(self) -> "CfgNode":
        out = CfgNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    # -- merging ---------------------------------------------------------
    def merge_from_dict(self, other: dict, _path: str = "") -> None:
        for k, v in other.items():
            key_path = f"{_path}.{k}" if _path else k
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v, key_path)
            else:
                if k not in self and _path:  # top-level new keys are allowed (BASE)
                    raise KeyError(f"Unknown config key: {key_path}")
                self[k] = CfgNode(v) if isinstance(v, dict) and k not in self else v

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML file, recursively resolving `BASE:` includes first
        (mirrors reference config.py:252-264)."""
        import yaml

        with open(cfg_file, "r") as f:
            yaml_cfg = yaml.safe_load(f) or {}
        for base in yaml_cfg.get("BASE", [""]):
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(cfg_file), base))
        yaml_cfg.pop("BASE", None)
        self.merge_from_dict(yaml_cfg)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        """Merge `KEY VALUE` pairs, e.g. ["DATA.BATCH_SIZE", "4"]
        (mirrors yacs merge_from_list used at reference config.py:271-272)."""
        opts = list(opts)
        assert len(opts) % 2 == 0, "--opts must be KEY VALUE pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            old = node.get(parts[-1])
            node[parts[-1]] = _coerce(value, old)

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(value: str, old: Any) -> Any:
    """Parse a CLI string against the type of the existing value."""
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        try:
            return int(value)
        except ValueError:
            return float(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, (list, tuple)) or old is None:
        import yaml

        try:
            return yaml.safe_load(value)
        except Exception:
            return value
    return value


# ---------------------------------------------------------------------------
# Default schema — mirrors reference config.py:5-249 key-for-key so that the
# reference's YAML experiment files translate 1:1.
# ---------------------------------------------------------------------------
def default_config() -> CfgNode:
    c = CfgNode()
    c.BASE = [""]

    # -- data (reference config.py:13-79) -----------------------------------
    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 24
    c.DATA.DATA_PATH = "data/"
    c.DATA.DATASET = "VCTK_092"
    c.DATA.MIC_ID = "mic1"
    c.DATA.RESAMPLER = "scipy"
    c.DATA.SHUFFLE = True
    c.DATA.NUM_WORKERS = 1
    c.DATA.USE_QUANTITY = 0.1
    c.DATA.TRAIN_SPLIT = [100, 8]
    c.DATA.VALID_SPLIT = 0.1
    c.DATA.TARGET_SR = 48000
    c.DATA.RANDOM_RESAMPLE = [8000, 48000]
    c.DATA.WEIGHTED_SR = CfgNode()
    c.DATA.WEIGHTED_SR.ENABLE = False
    c.DATA.WEIGHTED_SR.RANGES = [[8000, 16000], [16000, 24000], [24000, 48000]]
    c.DATA.WEIGHTED_SR.WEIGHTS = [0.5, 0.3, 0.2]
    c.DATA.SEGMENT = 2.555
    c.DATA.PAD_WHITENOISE = 1e-32
    c.DATA.STFT = CfgNode()
    c.DATA.STFT.N_FFT = 1024
    c.DATA.STFT.HOP_LENGTH = 240
    c.DATA.STFT.WIN_LENGTH = 1024
    c.DATA.STFT.SCALE = "log2"
    c.DATA.LPF = CfgNode()
    c.DATA.LPF.MULTIFILTER = False
    c.DATA.LPF.LPF_TRAIN = [
        ["cheby1", 6],
        ["cheby1", 8],
        ["cheby1", 10],
        ["cheby1", 12],
        ["bessel", 6],
        ["bessel", 12],
        ["ellip", 6],
        ["ellip", 12],
    ]
    c.DATA.LPF.LPF_TEST = [["cheby1", 6]]
    # TPU addition: input pipeline backend — "threads" (default) or "grain"
    # (multiprocess workers + multi-host input sharding support).
    c.DATA.PIPELINE = "threads"
    c.DATA.FLAC2WAV = CfgNode()
    c.DATA.FLAC2WAV.SRC_SR = 48000
    c.DATA.FLAC2WAV.SRC_PATH = "data/"
    c.DATA.FLAC2WAV.DST_PATH = "VCTK-Corpus-0.92/wav48_silence_trimmed_wav"
    c.DATA.FLAC2WAV.TIMESTAMPS = "./vctk-silence-labels/vctk-silences.0.92.txt"
    # The VMamba classifier's image side (MODEL.TYPE "vssm",
    # models/factory.py:build_classifier); no VM-ASR path reads it.
    c.DATA.IMG_SIZE = 224

    # -- model (reference config.py:84-121) ----------------------------------
    c.MODEL = CfgNode()
    c.MODEL.TYPE = "VM_ASR"
    c.MODEL.NAME = "VM_ASR_BASIC"
    c.MODEL.RESUME_PATH = None
    c.MODEL.DROP_RATE = 0.0
    # The VMamba classifier's classes (MODEL.TYPE "vssm"); no VM-ASR path
    # reads it.
    c.MODEL.NUM_CLASSES = 1000
    c.MODEL.VSSM = CfgNode()
    c.MODEL.VSSM.IN_CHANS = 1
    c.MODEL.VSSM.PATCH_SIZE = 4
    c.MODEL.VSSM.DEPTHS = [2, 2, 2, 2]
    c.MODEL.VSSM.DIMS = 16
    c.MODEL.VSSM.SSM_D_STATE = 1
    c.MODEL.VSSM.SSM_RATIO = 2.0
    c.MODEL.VSSM.SSM_DT_RANK = "auto"
    c.MODEL.VSSM.SSM_ACT_LAYER = "silu"
    c.MODEL.VSSM.SSM_CONV = 3
    c.MODEL.VSSM.SSM_CONV_BIAS = True
    c.MODEL.VSSM.SSM_DROP_RATE = 0.0
    c.MODEL.VSSM.SSM_INIT = "v0"
    c.MODEL.VSSM.SSM_FORWARDTYPE = "v5"
    c.MODEL.VSSM.MLP_RATIO = 4.0
    c.MODEL.VSSM.MLP_ACT_LAYER = "gelu"
    c.MODEL.VSSM.MLP_DROP_RATE = 0.0
    c.MODEL.VSSM.GMLP = False
    c.MODEL.VSSM.DROP_PATH_RATE = 0.1
    c.MODEL.VSSM.PATCH_NORM = True
    c.MODEL.VSSM.NORM_LAYER = "LN"
    c.MODEL.VSSM.PATCHEMBED = "v2"
    c.MODEL.VSSM.DOWNSAMPLE = "v1"
    c.MODEL.VSSM.UPSAMPLE = "v1"
    c.MODEL.VSSM.OUTPUT = "v3"
    c.MODEL.VSSM.CONCAT_SKIP = True
    c.MODEL.VSSM.INTERACT = "dual"
    # TPU addition: rematerialise VSS block activations in backward
    # (the analogue of the reference's use_checkpoint, vmamba.py:1839-1843)
    c.MODEL.VSSM.USE_CHECKPOINT = False
    # TPU addition: batch the two dual-stream decoder passes (which share
    # core_mag's weights in the production PHASE_DECODER_FIX=False path,
    # reference model.py:1148) into one call along the batch axis.
    # Identical per-sample math; halves the decoder's dispatch count.
    c.MODEL.VSSM.FUSE_STREAMS = False
    # TPU addition (serving): run eval/inference through the stream-stacked
    # execution model (models.unet.DualStreamStackedMambaUNet) — both
    # streams as one vmapped program over stacked weights, ~49% fewer
    # traced ops at flagship geometry, outputs identical (checkpoints stay
    # in the unstacked layout; conversion happens at load time).
    c.MODEL.VSSM.STACKED_EXECUTION = False
    # force_fp32 scan-boundary semantics (reference vmamba.py:842-848: v2/v5
    # cast the scan's activation inputs to fp32 even under AMP). Off: bf16
    # IO halves scan HBM traffic; the kernel accumulates in fp32 either way
    # (bwd ≤6.5e-4 rel at L=16384 — ~50× inside the reference's own bf16
    # tolerance). On: bit-faithful reference numerics at the scan boundary.
    c.MODEL.VSSM.SCAN_FP32_IO = False

    # -- training (reference config.py:126-192) -------------------------------
    c.TRAIN = CfgNode()
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.EPOCHS = 50
    c.TRAIN.WARMUP_EPOCHS = 10
    c.TRAIN.EARLY_STOPPING = 10
    c.TRAIN.WEIGHT_DECAY = 0.0
    c.TRAIN.BASE_LR = 1e-3
    c.TRAIN.MAX_LR = 1e-3
    c.TRAIN.MIN_LR = 1e-5
    c.TRAIN.CYCLE_MULT = 1.0
    c.TRAIN.ENABLE_GAN = False
    c.TRAIN.LOSSES = CfgNode()
    c.TRAIN.LOSSES.GEN = ["multi_resolution_stft"]
    c.TRAIN.METRICS = ["snr", "lsd", "lsd_hf", "lsd_lf"]
    c.TRAIN.LOW_FREQ_REPLACEMENT = False
    # "torch" = reference-faithful (a no-op for the (B,1,T) inputs every
    # production path uses — see models/unet.py lfr_mode docs); "fixed" =
    # the intended input-low-band replacement.
    c.TRAIN.LFR_MODE = "torch"
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.ACCUMULATION_STEPS = 1
    c.TRAIN.OPTIMIZER = CfgNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = [0.9, 0.999]
    c.TRAIN.OPTIMIZER.MOMENTUM = 0.9
    c.TRAIN.LR_SCHEDULER = CfgNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1
    c.TRAIN.LR_SCHEDULER.WARMUP_PREFIX = True
    c.TRAIN.LR_SCHEDULER.GAMMA = 0.1
    c.TRAIN.LR_SCHEDULER.MULTISTEPS = []
    c.TRAIN.ADVERSARIAL = CfgNode()
    c.TRAIN.ADVERSARIAL.ENABLE = False
    c.TRAIN.ADVERSARIAL.DISCRIMINATORS = [""]
    c.TRAIN.ADVERSARIAL.STFT_LOSS = CfgNode()
    c.TRAIN.ADVERSARIAL.STFT_LOSS.SC_FACTOR = 0.5
    c.TRAIN.ADVERSARIAL.STFT_LOSS.MAG_FACTOR = 0.5
    c.TRAIN.ADVERSARIAL.STFT_LOSS.EMPHASIZE_HIGH_FREQ = False
    c.TRAIN.ADVERSARIAL.MPD_HIDDEN = 32
    # TPU addition: period list is configurable (reference hardcodes
    # [2, 3, 5, 7, 11], discriminator.py:123)
    c.TRAIN.ADVERSARIAL.MPD_PERIODS = [2, 3, 5, 7, 11]
    # TPU addition: run the period discriminators as ONE vmapped stack
    # instead of 5 sequential conv stacks (loss-identical; see
    # discriminator.StackedMultiPeriodDiscriminator). STACK_GROUPS
    # partitions MPD_PERIODS in order into vmap groups ([] = one group of
    # all periods); finer groups trade op count for less padded-FLOP waste.
    # Keep False on dp×mp meshes (GSPMD grouped-conv kernel-grad bug — see
    # the class docstring); production GAN training is dp-only.
    c.TRAIN.ADVERSARIAL.MPD_STACKED = False
    c.TRAIN.ADVERSARIAL.MPD_STACK_GROUPS = []
    c.TRAIN.ADVERSARIAL.MSD_HIDDEN = 128
    c.TRAIN.ADVERSARIAL.FEATURE_LOSS_LAMBDA = 100
    c.TRAIN.ADVERSARIAL.ONLY_FEATURE_LOSS = False
    c.TRAIN.ADVERSARIAL.ONLY_ADVERSARIAL_LOSS = False
    c.TRAIN.ADVERSARIAL.GAN_LOSS_TYPE = "lsgan"
    c.TRAIN.ADVERSARIAL.GP_LAMBDA = 10
    # TPU addition (documented deliberate fix, default = reference-faithful):
    # constant gain applied to BOTH real and fake waveforms before every
    # discriminator. At audio scale (~0.5 peak) the GELU conv stacks sit in
    # their near-linear regime, where the real/fake difference — zero-mean
    # high-frequency content — is invisible to first order, so the MPD
    # converges to the blind LSGAN equilibrium (D ≡ 0.5, loss pinned at
    # 2.50) and never discriminates; the reference's torch MPD does the
    # same (scripts/diagnose_gan{,_ref}.py). Gain ≥ ~8 pushes activations
    # into the nonlinearity and the discriminator becomes adversarial.
    c.TRAIN.ADVERSARIAL.DISC_INPUT_GAIN = 1.0

    # -- test / inference (reference config.py:197-207) -----------------------
    c.TEST = CfgNode()
    c.TEST.RESULTS_DIR = "results"
    c.TEST.OVERLAP = 2000
    c.TEST.SAVE_RESULT = True
    # TPU addition: append device-compute-only RTF columns to the results
    # CSV (measured per XLA program, diff-D2H protocol) — separates
    # framework speed from host↔device transport. Reference columns keep
    # their exact order; these follow after (tester.COMPUTE_COLUMNS).
    c.TEST.COMPUTE_RTF = True
    c.INFERENCE = CfgNode()
    c.INFERENCE.RESULTS_DIR = "results_inference"
    c.INFERENCE.OVERLAP = 2000

    # -- misc (reference config.py:212-249) -----------------------------------
    c.DEBUG = False
    c.DEBUG_OUTPUT = "debug"
    c.N_GPU = 1  # kept for config-file parity; the port runs on one device
    c.AMP_ENABLE = True  # bfloat16 compute (DTYPE.COMPUTE) / fp32 params
    c.OUTPUT = "logs"
    c.TAG = "default"
    c.MONITOR = "min lsd"
    c.SAVE_EPOCH_FREQ = -1
    c.PRINT_FREQ = 10
    c.SEED = 123
    c.EVAL_MODE = False
    c.THROUGHPUT_MODE = False
    c.INFERENCE_MODE = False
    c.WANDB = CfgNode()
    c.WANDB.ENABLE = False
    c.WANDB.PROJECT = "VM_ASR"
    c.WANDB.ENTITY = None
    c.WANDB.MODE = "online"
    c.WANDB.LOG = "all"
    c.WANDB.RESUME = False
    c.WANDB.TAGS = []
    c.TENSORBOARD = CfgNode()
    c.TENSORBOARD.ENABLE = True
    c.TENSORBOARD.LOG_ITEMS = ["audio", "waveform", "spectogram"]

    # JAX-package additions (no reference equivalent) ---------------------------
    # Trace the first N train steps with jax.profiler (0 = off); the trace
    # lands in <OUTPUT>/profile for TensorBoard/Perfetto (the reference's
    # torch.profiler scaffold equivalent, vmamba.py:2795-2832).
    c.PROFILE_STEPS = 0
    c.MESH = CfgNode()
    c.MESH.DP = -1  # -1: all local devices on the data axis
    c.MESH.AXIS_NAMES = ["dp"]
    c.DTYPE = CfgNode()
    c.DTYPE.COMPUTE = "bfloat16"  # replaces CUDA AMP (reference trainer.py:138)
    c.DTYPE.PARAMS = "float32"
    c.DTYPE.SCAN = "float32"  # the scan is fp32-forced (reference vmamba.py:842-848)
    return c


def update_config(config: CfgNode, args) -> None:
    """Apply CLI overrides + derived updates (mirrors reference config.py:267-334)."""
    if getattr(args, "cfg", None):
        config.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)

    def has(name):
        return getattr(args, name, None)

    if has("batch_size"):
        config.DATA.BATCH_SIZE = args.batch_size
    if has("resume"):
        config.MODEL.RESUME_PATH = args.resume
        if config.MODEL.RESUME_PATH is not None and not config.EVAL_MODE:
            config.WANDB.RESUME = True
    if has("accumulation_steps"):
        config.TRAIN.ACCUMULATION_STEPS = args.accumulation_steps
    if has("disable_amp"):
        config.AMP_ENABLE = False
    if has("output"):
        config.OUTPUT = args.output
    if has("tag"):
        config.TAG = args.tag
    if has("eval"):
        config.EVAL_MODE = True
    if has("inference"):
        config.INFERENCE_MODE = True
    if has("throughput"):
        config.THROUGHPUT_MODE = True
    if has("optim"):
        config.TRAIN.OPTIMIZER.NAME = args.optim

    # Output folder layout `<output>/<model_name>/<tag>` (reference config.py:307-310)
    if config.MODEL.RESUME_PATH is None:
        config.OUTPUT = os.path.join(config.OUTPUT, config.MODEL.NAME, config.TAG)
    else:
        config.OUTPUT = config.MODEL.RESUME_PATH

    # Derived updates keyed on TARGET_SR (reference config.py:313-320)
    if config.DATA.TARGET_SR == 48000:
        config.DATA.RANDOM_RESAMPLE = [8000, 48000]
        config.DATA.STFT.HOP_LENGTH = 240
        config.DATA.WEIGHTED_SR.RANGES = [[8000, 16000], [16000, 24000], [24000, 48000]]
    else:
        config.DATA.RANDOM_RESAMPLE = [2000, 16000]
        config.DATA.STFT.HOP_LENGTH = 80
        config.DATA.WEIGHTED_SR.RANGES = [[2000, 8000], [8000, 12000], [12000, 16000]]

    # --input_sr collapses the random-resample range → specialised model
    # (reference config.py:322-327)
    if has("input_sr"):
        if config.DATA.TARGET_SR == 48000 and args.input_sr >= config.DATA.TARGET_SR:
            raise ValueError(
                f"Input sample rate should be less than {config.DATA.TARGET_SR}"
            )
        config.DATA.RANDOM_RESAMPLE = [args.input_sr]

    # LPF list truncation when MULTIFILTER off (reference config.py:330-332)
    if not config.EVAL_MODE:
        if not config.DATA.LPF.MULTIFILTER:
            config.DATA.LPF.LPF_TRAIN = [config.DATA.LPF.LPF_TRAIN[0]]

    config.freeze()


def get_config(args=None) -> CfgNode:
    """Build the frozen run config (mirrors reference config.py:337-344)."""
    config = default_config()
    if args is not None:
        update_config(config, args)
    else:
        config.freeze()
    return config


def load_config(cfg_file: str, opts: Optional[List[str]] = None) -> CfgNode:
    """Convenience loader used by tests and the library API."""
    config = default_config()
    config.merge_from_file(cfg_file)
    if opts:
        config.merge_from_list(opts)
    # derived updates without CLI args
    class _A:  # minimal args carrier
        cfg = None
    update_config(config, _A())
    return config
