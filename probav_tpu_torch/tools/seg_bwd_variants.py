"""Variants of ``seg_bwd_bf16_kernel`` (the bf16 expand/decay backward of
``blk_bwd`` on the tensor cores), timed side by side on one card.

    python3 probav_tpu_torch/tools/seg_bwd_variants.py [--variants a,b] \\
        [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/blk_bwd.cu`` (from
``constexpr int SBB_WARPS`` to the float32 seg_bwd) with the text
substitutions of ``VARIANTS`` (``kernel`` is the section as it is), in a
namespace of its own; all are compiled into one library by nvcc
(``wgrad_variants.compile_variants``, with ptxas's register and spill
report) and launched at the flagship's shape (N = 557,568 rows, 32/256/25)
into the G partial slots that blk_bwd gives them, on bf16 x, dd, gy and
weights on the dyadic grids of ``tools/dyadic.py`` (numpy seed 12).  For
each: its registers and spilled bytes, the ms per launch of 20 launches
back to back (CUDA events) in ``--rounds`` rounds taken in turn across the
variants, and the largest error over max|ref| of its dx and of its summed
slots (dW1, db1, dW2, db2, dbc) against ``tstack.seg_bwd_plain``.
Variants that drop work give wrong results by design.  Prints one JSON
line, also appended to ``DIR/seg_bwd_variants.jsonl`` with ``--out``.
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


def _shape(warps, rows, blocks):
    """Substitutions giving the kernel `warps` warps, tiles of `rows` rows
    and `blocks` blocks an SM."""
    return ((r"constexpr int SBB_WARPS = \d+;",
             f"constexpr int SBB_WARPS = {warps};"),
            (r"constexpr int SBB_ROWS = \d+;",
             f"constexpr int SBB_ROWS = {rows};"),
            (r"constexpr int SBB_MINB = \d+;",
             f"constexpr int SBB_MINB = {blocks};"))


# name: ((pattern, replacement), ...) applied to the kernel's section.
_PHASE_C = "phase_c(zt + (buf ^ 1) * 256 * ZS, rg * KPG, KPG);"
VARIANTS = {
    "kernel": (),
    # 64-row tiles (one block of 8 warps an SM, 135,424 B).  Two blocks of
    # 8 warps an SM (at most 116 KB and 128 registers each) or one of 16
    # warps do not fit the double-buffered dz^T space.
    "rows64": _shape(8, 64, 1),
    # The previous tile's phase C run whole after this tile's phases A and
    # B, not interleaved with them.
    "phase_c_after": ((r"(nothing of it is stored\)\.)\n\s*" +
                       re.escape(_PHASE_C), r"\1"),
                      (r"(    if \(prev >= 0\) \{\n)(\s+probav::cp_async_wait_"
                       r"group<2>)", r"\1      for (int rg = 0; rg < RG; "
                       r"++rg) " + _PHASE_C + r"\n\2")),
    # The 16-row group loop unrolled 2 deep, not 1.
    "unroll_2": ((r"#pragma unroll 1(\s+for \(int rg = 0)",
                  r"#pragma unroll 2\1"),),
    # Phases removed: every mma (no instruction; its operands still loaded
    # and kept live), phase C, the dz^T stores, the dd repack, the dx
    # stores, every tile (the block's set-up and slot alone).
    "no_mma": ((r"\bmma_bf16\(", "fake_mma("),),
    "no_phase_c": ((r"\bphase_c\(zt", "(void)(zt"),),
    "no_zt_store": ((r"\*reinterpret_cast<uint32_t\*>\(zp \+ r0 \+ 8 \* nt "
                     r"\+ 2 \* q\) = dzp;", "(void)zp;"),),
    "no_repack": ((r"repack\(dbt \+ \(buf \^ 1\) \* ROWS \* CS, skew, "
                   r"rows_of\(next\)\);", "(void)skew;"),),
    "no_dx_store": ((r"(E\* dst = dx \+ \(t \* ROWS \+ pr0\) \* c_in;)",
                     r"\1 if (n > 0) return;"),),
    "no_tiles": ((r"for \(long tile = blockIdx.x; tile < tiles;",
                  "for (long tile = tiles; tile < tiles;"),),
}

# mma_bf16 without the instruction: its operands are still loaded and
# kept live (also the bf16 seg_fwd variants' no_mma).
FAKE_MMA = """
__device__ __forceinline__ void fake_mma(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("" : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}
"""


def source(names) -> str:
    """One .cu: ``Slot`` and the helpers, then each variant's copy of the
    kernel's section in namespace v<i>, then an extern "C"
    ``launch(i, ...)``."""
    from probav_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    slot = text[text.index("struct Slot {"):text.index("};", text.index(
        "struct Slot {")) + 2]
    end = text.index("// seg_bwd, float32 on the tensor cores")
    section = text[text.index("constexpr int SBB_WARPS"):
                   text.rindex("\n", 0, text.rindex("\n", 0, end)) + 1]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "namespace {", slot, FAKE_MMA]
    cases = []
    for i, name in enumerate(names):
        body = section
        for pattern, new in VARIANTS[name]:
            body, hits = re.subn(pattern, new, body)
            if not hits:
                raise ValueError(f"variant {name}: {pattern!r} not in the "
                                 "kernel")
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"  if (v == {i}) return v{i}::launch_seg_bwd_bf16(x, "
                     "dd, gy, w1, b1, w2, dx, part, slot_len, G, n, c_in, "
                     "c_mid, c_dec, s);")
    parts += ["}  // namespace", 'extern "C" int launch(int v, const void* x, '
              "const void* dd, const void* gy, const void* w1, "
              "const float* b1, const void* w2, void* dx, float* part, "
              "long slot_len, int G, int n, int c_in, int c_mid, int c_dec, "
              "void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases, "  return -1;", "}"]
    return "\n".join(parts)


def slot_offsets(c_in, c_mid, c_dec):
    """(w1, w2, b1, b2, bc, len) of blk_bwd.cu's ``Slot``: dWc first."""
    w1 = 27 * c_dec * c_in
    w2 = w1 + c_in * c_mid
    b1 = w2 + c_mid * c_dec
    b2 = b1 + c_mid
    bc = b2 + c_dec
    return w1, w2, b1, b2, bc, bc + c_in


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
    import numpy as np
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.dyadic import grid
    from probav_tpu_torch.tools.time_conv import back_to_back
    from probav_tpu_torch.tools.wgrad_variants import compile_variants
    if not torch.cuda.is_available():
        raise SystemExit("seg_bwd_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, regs, spills = compile_variants(
        source(names), "seg_bwd_bf16_kernel", names,
        [I] + [P] * 8 + [ctypes.c_long] + [I] * 5 + [P])
    dev = torch.device("cuda")
    r = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    x, dd, gy = (t(grid(r, (N, C), 32, 4)), t(grid(r, (N, C_DEC), 32, 4)),
                 t(grid(r, (N, C), 32, 4)))
    w1, w2 = t(grid(r, (C, C_MID), 16, 6)), t(grid(r, (C_MID, C_DEC), 8, 5))
    b1 = torch.from_numpy(grid(r, (C_MID,), 16, 6)).to(dev)
    ref = ts.seg_bwd_plain(x, dd, gy, w1, b1, w2)
    groups = ts.partial_slots(dev, C, C_DEC)
    o1, o2, ob1, ob2, obc, slot_len = slot_offsets(C, C_MID, C_DEC)
    part = torch.empty(groups, slot_len, device=dev)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i):
        err = lib.launch(i, x.data_ptr(), dd.data_ptr(), gy.data_ptr(),
                         w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                         dx.data_ptr(), part.data_ptr(), slot_len, groups, N,
                         C, C_MID, C_DEC, stream)
        if err:
            raise RuntimeError(f"variant {names[i]}: CUDA error {err}")

    def rel(a, b):
        b = b.double()
        return float((a.double() - b).abs().max() / b.abs().max())

    result = dict(card=card, n=N, widths=[C, C_MID, C_DEC], groups=groups,
                  variants={})
    for i, name in enumerate(names):
        dx.fill_(float("nan"))
        part.fill_(float("nan"))
        call(i)
        torch.cuda.synchronize()
        s = part.double().sum(0)
        got = (dx, s[o1:o2].reshape(C, C_MID), s[ob1:ob2],
               s[o2:ob1].reshape(C_MID, C_DEC), s[ob2:obc], s[obc:])
        errs = [rel(a, b) for a, b in zip(got, ref)]
        result["variants"][name] = dict(
            registers=regs.get(name), spill_bytes=spills.get(name), ms=[],
            dx_rel_err=errs[0], grads_rel_err=max(errs[1:]))
    for _ in range(opt.rounds):
        for i, name in enumerate(names):
            result["variants"][name]["ms"].append(
                back_to_back(lambda: call(i)))
    for v in result["variants"].values():
        v["median_ms"] = statistics.median(v["ms"])
    line = json.dumps(result)
    print(line, flush=True)
    if opt.out:
        os.makedirs(opt.out, exist_ok=True)
        with open(os.path.join(opt.out, "seg_bwd_variants.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
