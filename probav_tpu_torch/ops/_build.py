"""Build the CUDA kernels of ``probav_tpu_torch/csrc`` and bind them.

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), which
``ctypes`` loads.  The library lands in ``probav_tpu_torch/_build/``
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
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # dtype, x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, stream
    "probav_seg_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dtype, d, x, wc, bc, out, B, H, W, T, c_dec, c_out, stream
    "probav_conv_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # dtype, gy, x, d, wflip, w1, b1, w2, dd, dx, part, out, dxp,
    # G, stride, B, H, W, T, c_in, c_mid, c_dec, stream
    "probav_blk_bwd": [_I] + [_P] * 12 + [_I] * 9 + [_P],
    # dtype, c_in, c_mid, c_dec, n, out int64[1]
    "probav_blk_bwd_scratch": [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong)],
    # dtype, c_in, c_mid, c_dec
    "probav_seg_fwd_route": [_I] * 4,
    # dtype, c_in, c_mid, c_dec
    "probav_seg_bwd_route": [_I] * 4,
    # dtype, c_in, c_dec, W, T
    "probav_wgrad_route": [_I] * 5,
    # dtype, x, w1, b1, w2, dy, dx, part, out, G, stride, n, c_in, c_mid,
    # c_dec, stream
    "probav_wide_bwd": [_I] + [_P] * 8 + [_I] * 6 + [_P],
    # dtype, c_in, c_mid, c_dec
    "probav_wide_bwd_route": [_I] * 4,
    # part, out, G, len, stride, stream
    "probav_reduce_partials": [_P, _P, _I, _I, _I, _P],
    # G, len, out int[4]
    "probav_reduce_partials_plan": [_I, _I, ctypes.POINTER(_I)],
    # hr, m, p, out, B, H, W, border, squared, stream
    "probav_shift_table_fwd": [_P] * 4 + [_I] * 5 + [_P],
    # hr, m, p, g, dp, B, H, W, border, squared, stream
    "probav_shift_table_bwd": [_P] * 5 + [_I] * 5 + [_P],
    # B, H, W, border, out int[8]
    "probav_shift_table_plan": [_I] * 4 + [ctypes.POINTER(_I)],
}


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def headers():
    return sorted(SRC_DIR.glob("*.cuh"))


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
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprobav_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists yet.

    Returns (library path, seconds spent compiling, compiler output, which
    ends with one "compiled <source> in <s> s" line per source).  With
    ``verbose`` ptxas reports each kernel's registers, shared memory and
    spills (and the library is rebuilt so that the report exists).
    """
    out = library_path()
    if out.exists() and not verbose:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    # Build in a private directory, then rename the library into place: a
    # concurrent build never sees a half-written one.
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    report = []
    try:
        objs = [tmp / (src.stem + ".o") for src in sources()]
        logs = [tmp / (src.stem + ".log") for src in sources()]
        procs = []
        for src, obj, log in zip(sources(), objs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *flags, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT))
        done = {}
        while len(done) < len(procs):
            for i, p in enumerate(procs):
                if i not in done and p.poll() is not None:
                    done[i] = time.perf_counter() - t0
            time.sleep(0.05)
        failed, timing = [], []
        for i, (src, p, log) in enumerate(zip(sources(), procs, logs)):
            text = log.read_text()
            report.append(text)
            timing.append(f"compiled {src.name} in {done[i]:.1f} s\n")
            if p.returncode != 0:
                failed.append(f"nvcc {src.name} ({p.returncode}):\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        report += timing
        lib = tmp / "lib.so"
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.perf_counter() - t0, "".join(report)


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
