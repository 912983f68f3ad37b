"""Console + file logging (port of vm_asr_tpu/core/logging.py, uncoloured)."""

from __future__ import annotations

import functools
import logging
import os
import sys

from .dist import process_rank


@functools.lru_cache()
def create_logger(output_dir: str = "", name: str = "vm_asr_tpu_torch") -> logging.Logger:
    """Console logger plus a plain-text ``log_rank0.txt`` in ``output_dir``.
    On a rank other than 0 of the process group the console shows warnings
    and errors only and no file is written."""
    rank = process_rank()
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):  # one set of handlers per name
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(levelname)s] %(asctime)s %(name)s: %(message)s",
                            datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir and rank == 0:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log_rank0.txt"), mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
