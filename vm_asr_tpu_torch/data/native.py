"""ctypes bindings for the host C++ library: polyphase resampling, zero-phase
SOS filtering, 16-bit PCM conversion and a FLAC decoder (port of
vm_asr_tpu/data/native.py; sources ``native/src/vm_asr_native.cpp`` and
``native/src/flac_decoder.cpp``, a plain C ABI).

The library is compiled from those sources in place with ``g++`` and the
flags of ``native/build.sh``, at first use, into ``build/native/`` at the
repository root, under a name keyed by a hash of the sources, the flags and
the host's CPU (``-march=native`` code does not move between machines).
Several processes may ask at once: one compiles under a file lock and
publishes the library with an atomic rename; the others wait and load it::

    python -c "from vm_asr_tpu_torch.data import native; print(native.build())"

There is no fallback: if ``g++`` is missing or the compile fails, ``load``
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCES = (REPO / "native" / "src" / "vm_asr_native.cpp",
           REPO / "native" / "src" / "flac_decoder.cpp")
BUILD_ROOT = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-shared", "-fPIC")  # native/build.sh

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _cpu_key() -> bytes:
    """The host CPU's model and feature flags, which ``-march=native``
    compiles for."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return os.uname().machine.encode()
    keep = [line for line in text.splitlines()
            if line.startswith(("model name", "flags", "Features", "CPU part"))]
    return "\n".join(sorted(set(keep))).encode()


def library_path() -> Path:
    """Where the library for these sources, flags and CPU lives."""
    h = hashlib.sha256()
    for path in SOURCES:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    return BUILD_ROOT / f"libvm_asr_native-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library unless it is built; returns the seconds the
    compile took (0.0 when it was already there). Raises with the
    compiler's output if the compile fails."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compile; the others wait for it
        if out.exists():
            return 0.0
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on $PATH: the host library "
                               f"({', '.join(p.name for p in SOURCES)}) cannot be built")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)  # atomic: a loader sees all of the library or none
        return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        build()
        lib = ctypes.CDLL(str(library_path()))
        lib.vm_resample_poly_out_len.restype = ctypes.c_int64
        lib.vm_resample_poly_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.vm_resample_poly.restype = ctypes.c_int64
        lib.vm_resample_poly.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                         _f32p]
        lib.vm_sosfiltfilt.restype = ctypes.c_int
        lib.vm_sosfiltfilt.argtypes = [_f64p, ctypes.c_int, _f32p, ctypes.c_int64, _f32p]
        lib.vm_pcm16_to_f32.restype = None
        lib.vm_pcm16_to_f32.argtypes = [_i16p, ctypes.c_int64, _f32p]
        lib.vm_f32_to_pcm16.restype = None
        lib.vm_f32_to_pcm16.argtypes = [_f32p, ctypes.c_int64, _i16p]
        ip = ctypes.POINTER(ctypes.c_int)
        lib.vm_flac_decode.restype = ctypes.c_int
        lib.vm_flac_decode.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                       ctypes.POINTER(_i32p), ctypes.POINTER(ctypes.c_int64),
                                       ip, ip, ip]
        lib.vm_flac_free.restype = None
        lib.vm_flac_free.argtypes = [_i32p]
        _LIB = lib
        return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """``scipy.signal.resample_poly(x, up, down)`` for 1-D float32 input."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(int(lib.vm_resample_poly_out_len(x.shape[-1], up, down)), np.float32)
    lib.vm_resample_poly(_ptr(x, _f32p), x.shape[-1], up, down, _ptr(out, _f32p))
    return out


def sosfiltfilt(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``scipy.signal.sosfiltfilt(sos, x)`` (method 'pad') for 1-D float32
    input; ValueError when ``x`` is too short for the padding."""
    lib = load()
    sos = np.ascontiguousarray(sos, np.float64)
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    if lib.vm_sosfiltfilt(_ptr(sos, _f64p), sos.shape[0], _ptr(x, _f32p), x.shape[-1],
                          _ptr(out, _f32p)) != 0:
        raise ValueError("input too short for sosfiltfilt padding")
    return out


def pcm16_to_f32(x: np.ndarray) -> np.ndarray:
    """int16 → float32, divided by 32768."""
    lib = load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.float32)
    lib.vm_pcm16_to_f32(_ptr(x, _i16p), x.size, _ptr(out, _f32p))
    return out


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    """float32 → int16: clipped to [-1, 1], times 32767, rounded."""
    lib = load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.vm_f32_to_pcm16(_ptr(x, _f32p), x.size, _ptr(out, _i16p))
    return out


def decode_flac(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream (a path or its bytes) → (samples, sample_rate):
    float32 of shape (channels, frames), each sample divided by
    2^(bits per sample − 1). ValueError on a malformed stream."""
    lib = load()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        blob = Path(path_or_bytes).read_bytes()
    buf = np.frombuffer(blob, np.uint8)
    out = _i32p()
    n_frames, sr, ch, bps = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vm_flac_decode(_ptr(buf, ctypes.POINTER(ctypes.c_uint8)), buf.size,
                            ctypes.byref(out), ctypes.byref(n_frames), ctypes.byref(sr),
                            ctypes.byref(ch), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc})")
    frames, channels = int(n_frames.value), int(ch.value)
    try:
        pcm = np.ctypeslib.as_array(out, shape=(frames * channels,)).copy()
    finally:
        lib.vm_flac_free(out)
    audio = pcm.reshape(frames, channels).T  # interleaved → (channels, frames)
    return audio.astype(np.float32) / float(1 << (int(bps.value) - 1)), int(sr.value)
