"""Variants of the tensor-core ``seg_fwd`` kernels, timed side by side on
one card: ``seg_fwd_tf32_kernel`` (float32, 3xTF32) and
``seg_fwd_bf16_kernel`` (bf16).

    python3 probav_tpu_torch/tools/seg_fwd_variants.py \\
        [--dtype float32|bfloat16] [--variants a,b] [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/tstack.cu`` (``SECTIONS``:
from its constants to the text after its launcher) with the
regular-expression substitutions of its dtype's table, ``VARIANTS``
(float32) or ``BF16_VARIANTS`` (``kernel`` is the section as it is), in a
namespace of its own; all are compiled into one library by nvcc
(``wgrad_variants.compile_variants``, with ptxas's register and spill
report) and launched at the flagship's shape (N = 557,568 rows, 32/256/25).
float32 runs on random-normal x and weights from a torch generator (seed
12; W1 scaled by C^-1/2, W2 by C_mid^-1/2, biases by 0.1), its error taken
against float64 over max|ref|; bf16 on the dyadic inputs of
``tools/dyadic.seg_fwd_inputs`` (numpy seed 12), on which the kernel
equals ``tstack.seg_fwd_plain`` bit for bit, its error taken against that
and whether it is bit-equal.  For each variant: its registers and spilled
bytes, the ms per launch of 20 launches back to back (CUDA events) in
``--rounds`` rounds taken in turn across the variants, and that error.
Variants that drop work give wrong results by design.  Prints one JSON
line, also appended to ``DIR/seg_fwd_variants.jsonl`` with ``--out``.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

N, C, C_MID, C_DEC = 128 * 22 * 22 * 9, 32, 256, 25


def _shape(warps, blocks, prefix="SFT"):
    """Substitutions giving the kernel `warps` warps and `blocks` blocks an
    SM."""
    return ((rf"constexpr int {prefix}_WARPS = \d+;",
             f"constexpr int {prefix}_WARPS = {warps};"),
            (rf"constexpr int {prefix}_MINB = \d+;",
             f"constexpr int {prefix}_MINB = {blocks};"))


# float32: name: ((pattern, replacement), ...) applied to the section.
VARIANTS = {
    "kernel": (),
    "warps8_blocks2": _shape(8, 2),
    "warps8_blocks1": _shape(8, 1),
    "warps12_blocks1": _shape(12, 1),
    "warps16_blocks1": _shape(16, 1),
    "one_product": ((r"for \(int term = 0; term < 3; \+\+term\)",
                     "for (int term = 0; term < 1; ++term)"),),
    # The pair loop of a chunk (four pairs) unrolled 1 or 2 deep, not 4.
    "unroll_1": ((r"#pragma unroll(\s+for \(int p = 0)",
                  r"#pragma unroll 1\1"),),
    "unroll_2": ((r"#pragma unroll(\s+for \(int p = 0)",
                  r"#pragma unroll 2\1"),),
    # Each chunk's decay products summed straight into the running sums.
    "no_fresh_sums": ((r"mma_term\(dc\[ct\], ah, bd\[ct\], term\)",
                       "mma_term(acc[ct], ah, bd[ct], term)"),),
}

# bf16: the same form.
BF16_VARIANTS = {
    "kernel": (),
    # 16-row tiles a warp: each step's weight fragments serve 1 or 4 (4
    # with one block an SM: two would cap it at 128 registers and spill).
    "mt1": ((r"constexpr int SFB_MT = \d+;", "constexpr int SFB_MT = 1;"),),
    "mt4_blocks1": ((r"constexpr int SFB_MT = \d+;",
                     "constexpr int SFB_MT = 4;"),) + _shape(8, 1, "SFB"),
    # Warps a block and blocks an SM (the kernel: 8 and 2).
    "warps8_blocks1": _shape(8, 1, "SFB"),
    "warps12_blocks1": _shape(12, 1, "SFB"),
    "warps16_blocks1": _shape(16, 1, "SFB"),
    "warps6_blocks2": _shape(6, 2, "SFB"),
    "warps4_blocks3": _shape(4, 3, "SFB"),
    # The 16 steps of middle channels in a loop, not unrolled.
    "rolled": ((r"#pragma unroll(\s+for \(int s = 0)",
                r"#pragma unroll 1\1"),),
    # Phases removed: every mma (no instruction; its operands still loaded
    # and kept live), the d stores (the span still staged), x's 16-byte
    # cp.async (plain copies instead, as for c_in % 8 != 0), every tile
    # (the block's set-up alone).
    "no_mma": ((r"\bmma_bf16\(", "fake_mma("),),
    "no_store": ((r"store_span_warp\(dst, span, skew, nr \* c_dec, lane\);",
                  "(void)dst;"),),
    "sync_x": ((r"const bool xvec = c_in % 8 == 0 &&",
                "const bool xvec = false &&"),),
    "no_tiles": ((r"for \(long tile = blockIdx.x; tile < tiles;",
                  "for (long tile = tiles; tile < tiles;"),),
}

# dtype: (the section's first text, the text after it, kernel, launcher,
# variants).
SECTIONS = {
    "float32": ("constexpr int SFT_WARPS",
                "// Which kernel probav_seg_fwd runs", "seg_fwd_tf32_kernel",
                "launch_seg_fwd_tf32", VARIANTS),
    "bfloat16": ("constexpr int SFB_WARPS", "// conv_fwd: an implicit GEMM",
                 "seg_fwd_bf16_kernel", "launch_seg_fwd_bf16",
                 BF16_VARIANTS),
}

_USING = """
using probav::copy_rows;
using probav::cp_async_commit;
using probav::cp_async_wait_all;
using probav::FragA;
using probav::FragB;
using probav::ldsm_x4;
using probav::mma_bf16;
using probav::mma_term;
using probav::relu_bf16x2;
using probav::sm_count;
using probav::split_a;
using probav::split_b;
"""


def source(names, dtype="float32") -> str:
    """One .cu: each variant's copy of the dtype's kernel section in
    namespace v<i>, then an extern "C" ``launch(i, ...)``."""
    from probav_tpu_torch.ops import _build
    from probav_tpu_torch.tools.seg_bwd_variants import FAKE_MMA
    start, end, _, launcher, table = SECTIONS[dtype]
    text = (_build.SRC_DIR / "tstack.cu").read_text()
    section = text[text.index(start):text.index(end)]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "namespace {", _USING, FAKE_MMA]
    cases = []
    for i, name in enumerate(names):
        body = section
        for pattern, new in table[name]:
            body, hits = re.subn(pattern, new, body)
            if not hits:
                raise ValueError(f"variant {name}: {pattern!r} not in the "
                                 "kernel")
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"  if (v == {i}) return v{i}::{launcher}(x, "
                     "w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);")
    parts += ["}  // namespace", 'extern "C" int launch(int v, const void* x, '
              "const void* w1, const void* b1, const void* w2, "
              "const void* b2, void* d, int n, int c_in, int c_mid, "
              "int c_dec, void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases, "  return -1;", "}"]
    return "\n".join(parts)


def inputs(torch, dev, dtype):
    """(x, w1, b1, w2, b2, reference d, error of d against it): float32
    random-normal against float64, bf16 dyadic against the plain twin."""
    if dtype == "float32":
        g = torch.Generator(device=dev).manual_seed(12)
        rn = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
        x = rn(N, C)
        w1, b1 = rn(C, C_MID, sc=C ** -0.5), rn(C_MID, sc=0.1)
        w2, b2 = rn(C_MID, C_DEC, sc=C_MID ** -0.5), rn(C_DEC, sc=0.1)
        ref = (torch.relu(x.double() @ w1.double() + b1.double()) @
               w2.double() + b2.double())
        err = lambda d: dict(rel_err_f64=float(
            (d.double() - ref).abs().max() / ref.abs().max()))
        return x, w1, b1, w2, b2, err
    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.dyadic import seg_fwd_inputs
    x, w1, b1, w2, b2 = seg_fwd_inputs(N, C, C_MID, C_DEC, seed=12,
                                       device=dev, dtype=torch.bfloat16)
    b1, b2 = b1.float(), b2.float()
    ref = ts.seg_fwd_plain(x, w1, b1, w2, b2)
    err = lambda d: dict(
        rel_err_plain=float((d.float() - ref.float()).abs().max() /
                            ref.float().abs().max()),
        bit_equal=bool(torch.equal(d, ref)))
    return x, w1, b1, w2, b2, err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=tuple(SECTIONS), default="float32")
    ap.add_argument("--variants")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    table = SECTIONS[opt.dtype][4]
    names = (opt.variants or ",".join(table)).split(",")
    if not set(names) <= set(table):
        raise SystemExit(f"--variants: a comma list of {', '.join(table)}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    from probav_tpu_torch.tools.tstack_roofline import back_to_back
    from probav_tpu_torch.tools.wgrad_variants import compile_variants
    if not torch.cuda.is_available():
        raise SystemExit("seg_fwd_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, regs, spills = compile_variants(
        source(names, opt.dtype), SECTIONS[opt.dtype][2], names,
        [I] + [P] * 6 + [I] * 4 + [P])
    dev = torch.device("cuda")
    x, w1, b1, w2, b2, err = inputs(torch, dev, opt.dtype)
    d = torch.empty(N, C_DEC, device=dev, dtype=x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i):
        e = lib.launch(i, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                       w2.data_ptr(), b2.data_ptr(), d.data_ptr(), N, C,
                       C_MID, C_DEC, stream)
        if e:
            raise RuntimeError(f"variant {names[i]}: CUDA error {e}")

    result = dict(card=card, dtype=opt.dtype, n=N, widths=[C, C_MID, C_DEC],
                  variants={})
    for i, name in enumerate(names):
        d.fill_(float("nan"))
        call(i)
        torch.cuda.synchronize()
        result["variants"][name] = dict(
            registers=regs.get(name), spill_bytes=spills.get(name), ms=[],
            **err(d))
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
        with open(os.path.join(opt.out, "seg_fwd_variants.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
