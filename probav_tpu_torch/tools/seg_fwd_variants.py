"""Variants of the tensor-core ``seg_fwd`` kernels, timed side by side on
one card: ``seg_fwd_tf32_kernel`` (float32, 3xTF32), ``seg_fwd_bf16_kernel``
(bf16), and beyond the flagship's widths ``seg_fwd_tf32_wide_kernel``
(float32, C_mid in chunks) and ``seg_fwd_bf16_wide_kernel`` (bf16, the
weights staged once a block).

    python3 probav_tpu_torch/tools/seg_fwd_variants.py \\
        [--section float32|bfloat16|wide|bf16_wide] [--variants a,b] \\
        [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/tstack.cu`` (``SECTIONS``:
from its constants to the text after its launcher) with the
regular-expression substitutions of its table, ``VARIANTS`` (float32),
``BF16_VARIANTS``, ``WIDE_VARIANTS`` or ``BF16_WIDE_VARIANTS`` (``kernel``
is the section as it is), in a namespace of its own; all are compiled
into one library by nvcc (``wgrad_variants.compile_variants``, with
ptxas's register and spill report; ``wide`` with blk_bwd.cu's
``dx_sum_kernel``, which its ``grid_split`` variant launches) and
launched at the train step's rows (N = 557,568): ``float32`` and
``bfloat16`` at the flagship's widths (32/256/25), ``wide`` and
``bf16_wide`` at the 64-filter model's (64/512/51).  float32 runs on
random-normal x and weights from a torch generator (seed 12; W1 scaled
by C^-1/2, W2 by C_mid^-1/2, biases by 0.1), its error taken
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

# The grid_split variant's launcher: C_mid's chunks over the grid (block b
# takes chunk b % chunks of the row tiles of slot b / chunks, its weights
# staged once), each chunk's d part in float32 (the last one's with b2),
# summed in chunk order by dx_sum_kernel<float>; scratch kept across calls.
_SPLIT_LAUNCH = """  const int nch = (c_mid + SFW_JC - 1) / SFW_JC;
  const int ldp = (c_dec + 3) / 4 * 4;
  const long G = std::max(1L, std::min(
      tiles, (long)std::max(per_sm, 1) * sm_count() / nch));
  static float* scratch = nullptr;
  static size_t have = 0;
  const size_t need = (size_t)n * ((size_t)ldp * (nch - 1) + c_dec) +
                      (size_t)4 * sm_count() * c_dec;
  if (need > have) {
    if (scratch != nullptr) cudaFree(scratch);
    err = cudaMalloc(&scratch, need * sizeof(float));
    if (err != cudaSuccess) return err;
    have = need;
  }
  float* dxp = scratch;                              // [nch - 1][n][ldp]
  float* last = dxp + (size_t)(nch - 1) * n * ldp;   // [n][c_dec], + b2
  float* red = last + (size_t)n * c_dec;             // dx_sum's column sums
  kern<<<(unsigned)(G * nch), SFW_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), last, dxp, ldp, n, c_in, c_mid, c_dec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dx_sum(dxp, nch - 1, ldp, (const float*)last,
                       static_cast<float*>(d), red, (long)c_dec,
                       4 * sm_count(), n, c_dec, 0L, s);
}"""

# The row_copies variant's copies: rows [0, R) of a [*, cols] tile at src
# into dst (row stride XS), zeros from row nrows on.
_ROW_COPIES = """  auto copy_rows_w = [&](float* dst, const float* src, int nrows,
                         int cols, bool vec, int R) {
    for (int r = warp; r < R; r += SFW_WARPS) {
      const bool in = r < nrows;
      const float* row = in ? src + (long)r * cols : src;
      if (vec) {
        for (int c = 4 * lane; c < cols; c += 128)
          probav::cp_async16_zfill(dst + r * XS + c, in ? row + c : src, in);
      } else {
        for (int c = lane; c < cols; c += 32)
          probav::cp_async4_zfill(dst + r * XS + c, in ? row + c : src, in);
      }
    }
  };
"""

# wide: the same form, on seg_fwd_tf32_wide_kernel's section.
WIDE_VARIANTS = {
    "kernel": (),
    # Two or eight n-tiles of z at a time, not four; the chunk's groups
    # not unrolled.
    "group2": ((r"constexpr int SFW_GROUP = \d+;",
                "constexpr int SFW_GROUP = 2;"),),
    "group8": ((r"constexpr int SFW_GROUP = \d+;",
                "constexpr int SFW_GROUP = 8;"),),
    "unroll1": ((r"#pragma unroll(\s+for \(int p = 0)",
                 r"#pragma unroll 1\1"),),
    # Work removed: every mma (operands still split and kept live); the
    # weights' restaging (chunks 0 and 1 staged once: what the copies
    # cost; the barriers stay).
    "no_mma": ((r"\bmma_term\(", "fake_mma_tf32("),),
    "no_restage": ((r"stage_w\(ch \+ 1 < nch \? ch \+ 1 : 0, wbuf \^ 1\);",
                    "if (s == 0) stage_w(1 % nch, 1);"),),
    # W2's and x's rows copied a warp a row (a lane four columns a
    # 16-byte copy, or one a 4-byte copy: no index divided), not by
    # copy_rows (consecutive threads on consecutive elements).
    "row_copies": (
        (r"(  // Chunk ch of W1 as the \[c\]\[j\] plane)",
         _ROW_COPIES + r"\1"),
        (r"copy_rows<(\w+), XS>\((.*?)\);", r"copy_rows_w(\2, \1);"),),
    # The alternative design: C_mid's chunks over the grid, no restaging,
    # float32 d parts summed by dx_sum_kernel<float>.
    "grid_split": (
        (r"float\* __restrict__ d,\n",
         "float* __restrict__ d, float* __restrict__ dxp, int ldp,\n"),
        (r"  const long items = blockIdx\.x < tiles\n.*?: 0;\n",
         "  const int kch = (int)(blockIdx.x % nch);\n"
         "  const long slot0 = blockIdx.x / nch, G = gridDim.x / nch;\n"
         "  const long items = slot0 < tiles ? (tiles - 1 - slot0) / G + 1"
         " : 0;\n"),
        (r"stage_x\(blockIdx\.x, 0\);\n    stage_w\(0, 0\);",
         "stage_x(slot0, 0);\n    stage_w(kch, 0);"),
        (r"const long tile = blockIdx\.x \+ s / nch \* gridDim\.x;\n.*?"
         r"const int xbuf = \(int\)\(s / nch % 2\);",
         "const long tile = slot0 + s * G;\n"
         "    const int ch = kch, wbuf = 0, xbuf = (int)(s % 2);"),
        (r"stage_w\(ch \+ 1 < nch \? ch \+ 1 : 0, wbuf \^ 1\);\n"
         r"      if \(ch \+ 1 == nch\) stage_x",
         "stage_x"),
        (r"stage_x\(tile \+ gridDim\.x, xbuf \^ 1\)",
         "stage_x(tile + G, xbuf ^ 1)"),
        (r"if \(ch == 0\) \{", "if (true) {"),
        (r"if \(ch == nch - 1\) \{", "if (true) {"),
        (r"const float bb0 = b2s\[c\], bb1 = b2s\[c \+ 1\];",
         "const bool lc = kch + 1 == nch;\n"
         "        const float bb0 = lc ? b2s[c] : 0.f, "
         "bb1 = lc ? b2s[c + 1] : 0.f;"),
        (r"float\* dst = d \+ r0 \* c_dec;\n(.*?)dst\[e\] = ",
         "const int ld = kch + 1 < nch ? ldp : c_dec;\n"
         "      float* dst = (kch + 1 < nch ? dxp + (long)kch * n * ldp : d)"
         " + r0 * ld;\n\\1dst[r * ld + c] = "),
        (r"  const long grid = std::min\(tiles, .*?  return "
         r"cudaGetLastError\(\);\n\}", _SPLIT_LAUNCH)),
}

# bf16_wide: the same form, on seg_fwd_bf16_wide_kernel's section.
BF16_WIDE_VARIANTS = {
    "kernel": (),
    # One 16-row tile a warp (each step's weight fragments serve one), at
    # 8, 12 or 16 warps a block (16: 128 registers a thread at most).
    "mt1": ((r"constexpr int SFBW_MT = \d+;",
             "constexpr int SFBW_MT = 1;"),),
    "warps12_mt1": ((r"constexpr int SFBW_MT = \d+;",
                     "constexpr int SFBW_MT = 1;"),) + _shape(12, 1, "SFBW"),
    "warps16_mt1": ((r"constexpr int SFBW_MT = \d+;",
                     "constexpr int SFBW_MT = 1;"),) + _shape(16, 1, "SFBW"),
    # The pairs of steps unrolled 2 deep, not rolled.
    "unroll2": ((r"#pragma unroll 1(\s+for \(int s = 0)",
                 r"#pragma unroll 2\1"),),
    # Phases removed: every mma (its operands still loaded and kept live),
    # the d stores (the span still staged), x's 16-byte cp.async (plain
    # copies instead), the weights' staging (the planes still zeroed),
    # every tile (the block's set-up alone).
    "no_mma": ((r"\bmma_bf16\(", "fake_mma("),),
    "no_store": ((r"store_span_warp\(dst, xt, skew, nr \* c_dec, lane\);",
                  "(void)dst;"),),
    "sync_x": ((r"const bool xvec = c_in % 8 == 0 &&",
                "const bool xvec = false &&"),),
    "no_stage_w": ((r"  // W1's rows as they lie in memory.*?c_dec\);\n",
                    ""),),
    "no_tiles": ((r"for \(long tile = blockIdx.x; tile < tiles;",
                  "for (long tile = tiles; tile < tiles;"),),
}

# Substitutions applied to every variant of a section: bf16_wide keeps the
# one instantiation that its widths launch, <KS, NT> = <4, 7>, so that
# ptxas's report names its registers.
_ONLY = {"bf16_wide": (
    (r"  if \(c_in <= 48 && c_dec <= 40\)\n.*?(  if \(c_dec <= 56\))", r"\1"),
    (r"return launch_seg_fwd_bf16_wide_as<4, 8>\(.*?\);",
     "return cudaErrorInvalidValue;"))}

# section: (its first text, the text after it, kernel, launcher, variants,
# widths); every section's dtype is its kernel's.
SECTIONS = {
    "float32": ("constexpr int SFT_WARPS",
                "// seg_fwd, float32, on the tensor cores as 3xTF32 beyond",
                "seg_fwd_tf32_kernel", "launch_seg_fwd_tf32", VARIANTS,
                (C, C_MID, C_DEC)),
    "bfloat16": ("constexpr int SFB_WARPS",
                 "// seg_fwd, bf16, designed for Hopper past the flagship",
                 "seg_fwd_bf16_kernel", "launch_seg_fwd_bf16",
                 BF16_VARIANTS, (C, C_MID, C_DEC)),
    "wide": ("constexpr int SFW_WARPS", "// Which kernel probav_seg_fwd runs",
             "seg_fwd_tf32_wide_kernel", "launch_seg_fwd_tf32_wide",
             WIDE_VARIANTS, (64, 512, 51)),
    "bf16_wide": ("constexpr int SFBW_WARPS", "// conv_fwd: an implicit GEMM",
                  "seg_fwd_bf16_wide_kernel", "launch_seg_fwd_bf16_wide",
                  BF16_WIDE_VARIANTS, (64, 512, 51)),
}

_USING = """
using probav::copy_rows;
using probav::from_f;
using probav::to_f;
using probav::cp_async_commit;
using probav::cp_async_wait_all;
using probav::FragA;
using probav::FragB;
using probav::ldsm_x4;
using probav::ldsm_x4_trans;
using probav::mma_bf16;
using probav::mma_term;
using probav::relu_bf16x2;
using probav::sm_count;
using probav::split_a;
using probav::store_span_warp;
using probav::split_b;
"""


def source(names, section="float32") -> str:
    """One .cu: each variant's copy of the section's kernel in namespace
    v<i> (with the section's ``_ONLY`` substitutions), then an extern "C"
    ``launch(i, ...)``; ``wide`` also with blk_bwd.cu's dx_sum_kernel and
    its launcher."""
    from probav_tpu_torch.ops import _build
    from probav_tpu_torch.tools.seg_bwd_variants import FAKE_MMA
    start, end, _, launcher, table, _ = SECTIONS[section]
    text = (_build.SRC_DIR / "tstack.cu").read_text()
    body0 = text[text.index(start):text.index(end)]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "namespace {", _USING, FAKE_MMA]
    if section == "wide":
        bwd = (_build.SRC_DIR / "blk_bwd.cu").read_text()
        parts.append(bwd[bwd.index("// dx = T(sum over the chunks of dxp + "
                                   "gy)"):
                         bwd.index("cudaError_t launch_seg_bwd_split(")])
    cases = []
    for i, name in enumerate(names):
        body = body0
        for pattern, new in table[name] + _ONLY.get(section, ()):
            body, hits = re.subn(pattern, new, body, flags=re.S)
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


def inputs(torch, dev, section):
    """(x, w1, b1, w2, b2, error of d against its reference) at the
    section's widths: float32 random-normal against float64, bf16 dyadic
    against the plain twin."""
    c, c_mid, c_dec = SECTIONS[section][5]
    if section in ("float32", "wide"):
        g = torch.Generator(device=dev).manual_seed(12)
        rn = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
        x = rn(N, c)
        w1, b1 = rn(c, c_mid, sc=c ** -0.5), rn(c_mid, sc=0.1)
        w2, b2 = rn(c_mid, c_dec, sc=c_mid ** -0.5), rn(c_dec, sc=0.1)
        ref = (torch.relu(x.double() @ w1.double() + b1.double()) @
               w2.double() + b2.double())
        err = lambda d: dict(rel_err_f64=float(
            (d.double() - ref).abs().max() / ref.abs().max()))
        return x, w1, b1, w2, b2, err
    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.dyadic import seg_fwd_inputs
    x, w1, b1, w2, b2 = seg_fwd_inputs(N, c, c_mid, c_dec, seed=12,
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
    ap.add_argument("--section", choices=tuple(SECTIONS),
                    default="float32")
    ap.add_argument("--variants")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    table = SECTIONS[opt.section][4]
    c, c_mid, c_dec = SECTIONS[opt.section][5]
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
        source(names, opt.section), SECTIONS[opt.section][2], names,
        [I] + [P] * 6 + [I] * 4 + [P])
    dev = torch.device("cuda")
    x, w1, b1, w2, b2, err = inputs(torch, dev, opt.section)
    d = torch.empty(N, c_dec, device=dev, dtype=x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i):
        e = lib.launch(i, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                       w2.data_ptr(), b2.data_ptr(), d.data_ptr(), N, c,
                       c_mid, c_dec, stream)
        if e:
            raise RuntimeError(f"variant {names[i]}: CUDA error {e}")

    result = dict(card=card, section=opt.section, n=N,
                  widths=[c, c_mid, c_dec], variants={})
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
