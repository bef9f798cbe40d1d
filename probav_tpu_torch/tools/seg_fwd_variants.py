"""Variants of ``seg_fwd_tf32_kernel`` (the float32 ``seg_fwd`` on the
tensor cores), timed side by side on one card.

    python3 probav_tpu_torch/tools/seg_fwd_variants.py [--variants a,b] \\
        [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/tstack.cu`` (from
``constexpr int SFT_WARPS`` to its route) with the regular-expression
substitutions of ``VARIANTS`` (``kernel`` is the section as it is), in a
namespace of its own; all are compiled into one library by nvcc
(``wgrad_variants.compile_variants``, with ptxas's register and spill
report) and launched at the flagship's shape (N = 557,568 rows, 32/256/25)
on random-normal x and weights from a torch generator (seed 12; W1 scaled
by C^-1/2, W2 by C_mid^-1/2, biases by 0.1).  For each: its registers and
spilled bytes, the ms per launch of 20 launches back to back (CUDA events)
in ``--rounds`` rounds taken in turn across the variants, and the error of
its d against float64 over max|ref|.  Variants that drop work give wrong
results by design.  Prints one JSON line, also appended to
``DIR/seg_fwd_variants.jsonl`` with ``--out``.  Needs a CUDA card.
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


def _shape(warps, blocks):
    """Substitutions giving the kernel `warps` warps and `blocks` blocks an
    SM."""
    return ((r"constexpr int SFT_WARPS = \d+;",
             f"constexpr int SFT_WARPS = {warps};"),
            (r"constexpr int SFT_MINB = \d+;",
             f"constexpr int SFT_MINB = {blocks};"))


# name: ((pattern, replacement), ...) applied to the kernel's section.
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

_USING = """
using probav::copy_rows;
using probav::cp_async_commit;
using probav::cp_async_wait_all;
using probav::FragA;
using probav::FragB;
using probav::mma_term;
using probav::sm_count;
using probav::split_a;
using probav::split_b;
"""


def source(names) -> str:
    """One .cu: each variant's copy of the kernel's section in namespace
    v<i>, then an extern "C" ``launch(i, ...)``."""
    from probav_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "tstack.cu").read_text()
    section = text[text.index("constexpr int SFT_WARPS"):
                   text.index("// Which kernel probav_seg_fwd runs")]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "namespace {", _USING]
    cases = []
    for i, name in enumerate(names):
        body = section
        for pattern, new in VARIANTS[name]:
            body, hits = re.subn(pattern, new, body)
            if not hits:
                raise ValueError(f"variant {name}: {pattern!r} not in the "
                                 "kernel")
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"  if (v == {i}) return v{i}::launch_seg_fwd_tf32(x, "
                     "w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);")
    parts += ["}  // namespace", 'extern "C" int launch(int v, const void* x, '
              "const void* w1, const void* b1, const void* w2, "
              "const void* b2, void* d, int n, int c_in, int c_mid, "
              "int c_dec, void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases, "  return -1;", "}"]
    return "\n".join(parts)


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

    from probav_tpu_torch.tools.time_conv import back_to_back
    from probav_tpu_torch.tools.wgrad_variants import compile_variants
    if not torch.cuda.is_available():
        raise SystemExit("seg_fwd_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, regs, spills = compile_variants(
        source(names), "seg_fwd_tf32_kernel", names, [I] + [P] * 6 +
        [I] * 4 + [P])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    rn = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    x = rn(N, C)
    w1, b1 = rn(C, C_MID, sc=C ** -0.5), rn(C_MID, sc=0.1)
    w2, b2 = rn(C_MID, C_DEC, sc=C_MID ** -0.5), rn(C_DEC, sc=0.1)
    ref = (torch.relu(x.double() @ w1.double() + b1.double()) @
           w2.double() + b2.double())
    d = torch.empty(N, C_DEC, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(i):
        err = lib.launch(i, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), d.data_ptr(), N, C,
                         C_MID, C_DEC, stream)
        if err:
            raise RuntimeError(f"variant {names[i]}: CUDA error {err}")

    result = dict(card=card, n=N, widths=[C, C_MID, C_DEC], variants={})
    for i, name in enumerate(names):
        d.fill_(float("nan"))
        call(i)
        torch.cuda.synchronize()
        result["variants"][name] = dict(
            registers=regs.get(name), spill_bytes=spills.get(name), ms=[],
            rel_err_f64=float((d.double() - ref).abs().max() /
                              ref.abs().max()))
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
        with open(os.path.join(opt.out, "seg_fwd_variants.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
