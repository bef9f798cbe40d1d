"""Where the time of ``wgrad_tf32_kernel`` (blk_bwd's float32 dWc) goes:
variants of its source, timed side by side on one card.

    python3 probav_tpu_torch/tools/wgrad_variants.py [--variants a,b] \\
        [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/blk_bwd.cu`` with the text
substitutions of ``VARIANTS`` (``kernel`` is the section as it is), in a
namespace of its own; all are compiled into one library by nvcc, with
ptxas's register report, and launched at the flagship's shapes (128 x 22 x
22 x 9 positions, 25 -> 32 channels, random-normal d and gy from a torch
generator, seed 12) into the G partial slots blk_bwd gives them.  For each:
its registers, the ms per launch of 20 launches back to back (CUDA events)
in ``--rounds`` rounds taken in turn across the variants, and the error of
its slots' float64 sum against ``time_conv.dwc_float64`` over max|ref|.
Variants that drop work give wrong sums by design.  Prints one JSON line,
also appended to ``DIR/wgrad_variants.jsonl`` with ``--out``.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

SHAPE, C_DEC, C_OUT = (128, 22, 22, 9), 25, 32

_MMA = ("            for (int n = 0; n < 2; ++n) "
        "mma_term(f[dt][n], a[dt], b[n], term);")
# name: ((old, new), ...) applied to the kernel's section.
VARIANTS = {
    "kernel": (),
    # The products' words still loaded and split, and kept live.
    "no_mma": ((_MMA, """            for (int n = 0; n < 2; ++n)
              f[dt][n][term] += __uint_as_float(
                  a[dt].h[term] ^ a[dt].l[term] ^ a[dt].h[3] ^ a[dt].l[3] ^
                  b[n].h[term & 1] ^ b[n].l[term & 1]);"""),),
    "one_product": (("for (int term = 0; term < 3; ++term)",
                     "for (int term = 0; term < 1; ++term)"),),
    "no_split": (("split_b(", "raw_b("), ("split_a(", "raw_a(")),
    # hi = the raw word (the tensor cores read its top 19 bits), lo = v -
    # (v & mask): two instructions a word, not three.
    "truncating_split": (("split_b(", "trunc_b("), ("split_a(", "trunc_a(")),
    "no_copies_after_first": (("    if (item + 1 < i1) {",
                               "    if (false) {"),),
    "staging_only": (("if (hh < 0 || hh >= H) continue;", "continue;"),),
    "unroll_1": (("#pragma unroll 2", "#pragma unroll 1"),),
    "unroll_4": (("#pragma unroll 2", "#pragma unroll 4"),),
    "gy_4_byte_copies": (("const bool gvec = c_out % 4 == 0 &&",
                          "const bool gvec = false &&"),),
    # Each item's products summed straight into the running sums.
    "no_fresh_sums": (("mma_term(f[dt][n], a[dt], b[n], term)",
                       "mma_term(acc[dw][dt][n], a[dt], b[n], term)"),
                      ("acc[dw][dt][n][i] += f[dt][n][i];",
                       "(void)f[dt][n][i];")),
}

_HELPERS = """
using probav::FragA;
using probav::FragB;
using probav::mma_term;
using probav::split_a;
using probav::split_b;
__device__ __forceinline__ void raw_a(FragA& f, float a0, float a1, float a2,
                                      float a3) {
  const float v[4] = {a0, a1, a2, a3};
  for (int j = 0; j < 4; ++j) f.h[j] = f.l[j] = __float_as_uint(v[j]);
}
__device__ __forceinline__ void raw_b(FragB& f, float b0, float b1) {
  f.h[0] = f.l[0] = __float_as_uint(b0);
  f.h[1] = f.l[1] = __float_as_uint(b1);
}
__device__ __forceinline__ void trunc_split(float v, uint32_t& h,
                                            uint32_t& l) {
  h = __float_as_uint(v);
  l = __float_as_uint(v - __uint_as_float(h & 0xffffe000u));
}
__device__ __forceinline__ void trunc_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  trunc_split(a0, f.h[0], f.l[0]);
  trunc_split(a1, f.h[1], f.l[1]);
  trunc_split(a2, f.h[2], f.l[2]);
  trunc_split(a3, f.h[3], f.l[3]);
}
__device__ __forceinline__ void trunc_b(FragB& f, float b0, float b1) {
  trunc_split(b0, f.h[0], f.l[0]);
  trunc_split(b1, f.h[1], f.l[1]);
}
"""


def source(names) -> str:
    """One .cu: the fragment helpers of common.cuh, then each variant's copy
    of the kernel's section in namespace v<i>, then an extern "C"
    ``launch(i, ...)``."""
    from probav_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    section = text[text.index("constexpr int WGT_WARPS"):
                   text.index("// Which wgrad blk_bwd runs")]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "namespace {", _HELPERS]
    cases = []
    for i, name in enumerate(names):
        body = section
        for old, new in VARIANTS[name]:
            if old not in body:
                raise ValueError(f"variant {name}: {old!r} not in the kernel")
            body = body.replace(old, new)
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"  if (v == {i}) return v{i}::launch_wgrad_tf32(d, gy, "
                     "part, slot_len, G, B, H, W, Tn, c_dec, c_out, s);")
    parts += ["}  // namespace", 'extern "C" int launch(int v, const void* d, '
              "const void* gy, float* part, long slot_len, int G, int B, "
              "int H, int W, int Tn, int c_dec, int c_out, void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases, "  return -1;", "}"]
    return "\n".join(parts)


def compile_variants(src: str, kernel: str, names, argtypes):
    """(ctypes library, {variant: registers}, {variant: spill bytes}) of
    ``src``, whose variant i holds ``kernel`` in namespace v<i> and whose
    extern "C" ``launch`` takes ``argtypes``; compiled by nvcc with ptxas's
    register report."""
    from probav_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    cu, so = os.path.join(tmp, "variants.cu"), os.path.join(tmp, "v.so")
    with open(cu, "w") as f:
        f.write(src)
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                        "-v", "-shared", "-o", so, cu], capture_output=True,
                       text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc ({r.returncode}):\n{r.stderr[-3000:]}")
    regs, spills, current = {}, {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(rf"Compiling entry function '\w*v(\d+){len(kernel)}"
                      rf"{kernel}", line)
        if m:
            current = names[int(m.group(1))]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            spills[current] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            regs[current], current = int(m.group(1)), None
    lib = ctypes.CDLL(so)
    shutil.rmtree(tmp, ignore_errors=True)   # loaded: the files can go
    lib.launch.argtypes = argtypes
    lib.launch.restype = ctypes.c_int
    return lib, regs, spills


def build(names):
    """(ctypes library, {variant: registers}) of the variants' kernels."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, regs, _ = compile_variants(
        source(names), "wgrad_tf32_kernel", names,
        [I, P, P, P, ctypes.c_long] + [I] * 7 + [P])
    return lib, regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    names = opt.variants.split(",")
    if not set(names) <= set(VARIANTS):
        raise SystemExit(f"--variants: a comma list of {', '.join(VARIANTS)}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.time_conv import dwc_float64
    from probav_tpu_torch.tools.tstack_roofline import back_to_back
    if not torch.cuda.is_available():
        raise SystemExit("wgrad_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    lib, regs = build(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    d = torch.randn(*SHAPE, C_DEC, generator=g, device=dev)
    gy = torch.randn(*SHAPE, C_OUT, generator=g, device=dev)
    groups = ts.partial_slots(dev, C_OUT, C_DEC)
    slot = 27 * C_DEC * C_OUT
    part = torch.empty(groups, slot, device=dev)
    ref = dwc_float64(d, gy).reshape(27, C_DEC, C_OUT)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i):
        err = lib.launch(i, d.data_ptr(), gy.data_ptr(), part.data_ptr(),
                         slot, groups, *SHAPE, C_DEC, C_OUT, stream)
        if err:
            raise RuntimeError(f"variant {names[i]}: CUDA error {err}")

    result = dict(card=card, shape=list(SHAPE), c_dec=C_DEC, c_out=C_OUT,
                  variants={})
    for i, name in enumerate(names):
        call(i)
        torch.cuda.synchronize()
        got = part.double().sum(0).reshape(27, C_DEC, C_OUT)
        result["variants"][name] = dict(
            registers=regs.get(name), ms=[],
            rel_err_f64=float((got - ref).abs().max() / ref.abs().max()))
    for _ in range(opt.rounds):
        for i, name in enumerate(names):
            result["variants"][name]["ms"].append(
                back_to_back(torch, lambda: call(i))[0])
    for v in result["variants"].values():
        v["median_ms"] = statistics.median(v["ms"])
    line = json.dumps(result)
    print(line, flush=True)
    if opt.out:
        os.makedirs(opt.out, exist_ok=True)
        with open(os.path.join(opt.out, "wgrad_variants.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
