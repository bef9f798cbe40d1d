"""The native frame selector of stage 4 (port of
``probav_tpu/data/_native.py``), loaded with ctypes.

``native/select_frames.cpp`` is compiled with ``g++`` at first use into
``probav_tpu_torch/_build/``, under a name keyed by a hash of the source
and the flags, as ``ops/_build.py`` keys the CUDA kernels: an edited
source is rebuilt, an unchanged one reused.  Unlike the JAX package, the
port does not fall back to Python: a failed build raises with the
compiler's message.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "native" / "select_frames.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libprobav_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the selector unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name, then rename into place: a concurrent
    # build never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ {SRC.name} failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded selector library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.probav_select_frames.restype = ctypes.c_int
    lib.probav_select_frames.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def select_frames(occ_counts: np.ndarray, k: int, clarity_threshold: float,
                  hw: int):
    """Native stage-4 frame selection; see qc.select_frame_indices."""
    lib = library()
    occ = np.ascontiguousarray(occ_counts, dtype=np.int64)
    if occ.ndim != 3:
        raise ValueError(f"occlusion counts must be [S, P, T], got "
                         f"{occ.shape}")
    s, p, t = occ.shape
    out = np.empty((s, p, k), dtype=np.int32)
    stats = np.zeros(2, dtype=np.int64)
    rc = lib.probav_select_frames(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        s, p, t, k, (1.0 - clarity_threshold) * hw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError(f"probav_select_frames failed with rc={rc}")
    return out, int(stats[0]), int(stats[1])
