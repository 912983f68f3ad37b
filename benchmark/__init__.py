"""The benchmark of the PyTorch/CUDA port (``vm_asr_tpu_torch``): a harness
driven by the files of this folder, a frozen plain reference, and the
counters and trace readers of the per-layer metrics. ``run.py`` runs one
cell; ``controls.py`` reads the program, the control and the faults over
many seeds, the readings that the limits in ``limits/`` were set from."""
