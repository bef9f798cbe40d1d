"""Build the CUDA kernels of ``probav_tpu_torch/csrc`` and bind them.

The sources are compiled at first use with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
which ``ctypes`` loads.  The library lands in ``probav_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # dtype, x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, stream
    "probav_seg_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, d, x, wc, bc, out, B, H, W, T, c_dec, c_out, stream
    "probav_conv_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprobav_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists yet.

    Returns (library path, seconds spent compiling, compiler output).  With
    ``verbose`` ptxas reports each kernel's registers, shared memory and
    spills (and the library is rebuilt so that the report exists).
    """
    out = library_path()
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources()]
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    # Compile to a private name, then rename: a concurrent build never sees
    # a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run([nvcc_path(), *flags, "-o", tmp, *cu],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, r.stdout + r.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.probav_error_string.argtypes = [ctypes.c_int]
    lib.probav_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = library().probav_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
