"""VM-ASR in PyTorch for NVIDIA Hopper: the port of the JAX package
``vm_asr_tpu``, with its Pallas kernels rewritten as CUDA kernels.

Imports torch, numpy and scipy, never JAX nor the JAX package."""
