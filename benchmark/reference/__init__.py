"""The benchmark's plain reference of VM-ASR: the dual-stream generator,
the multi-period discriminator, the losses, AdamW, the selective scan as a
doubling scan, the STFT and the request layer's resampling, padding and
overlap-add, in plain PyTorch, NumPy and SciPy.

It is a frozen copy written from the published model (ghnmqdtg/VM-ASR) and
the port's module layout, so that its parameter names are the port's and one
state dict serves both. It imports nothing of the program and nothing of
JAX: what decides ``correct`` cannot move when the program does.

Every product (linear, convolution, einsum) goes through ``Products``:
fp32 with TF32 off for the reference, or fp8 (e4m3 forward, e5m2 backward,
one scale a tensor) for the control that must read as not correct.
"""
