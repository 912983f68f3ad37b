"""A fixture for the port's CPU tests: the JAX package runs the port's build
of the host C++ library.

Both packages bind the same sources (``native/src``). The port builds them
at first use (``vm_asr_tpu_torch/data/native.py``); the JAX package loads
``native/lib/libvm_asr_native.so``, built by hand with ``native/build.sh``,
and takes scipy when it is absent. Without this fixture the port would
filter and resample in C++ and the JAX package in scipy, and batches could
not be compared bit for bit. The fixture points the JAX binding at the
port's library for the module, and restores its path and state afterwards.
Import it into a test module to use it.
"""

import pytest

from vm_asr_tpu.data import native as jax_native
from vm_asr_tpu_torch.data import native


@pytest.fixture(autouse=True, scope="module")
def jax_uses_port_native():
    saved = (jax_native._LIB_PATH, jax_native._LIB, jax_native._TRIED)
    native.build()
    jax_native._LIB_PATH = str(native.library_path())
    jax_native._LIB, jax_native._TRIED = None, False
    assert jax_native.available()
    yield
    jax_native._LIB_PATH, jax_native._LIB, jax_native._TRIED = saved
