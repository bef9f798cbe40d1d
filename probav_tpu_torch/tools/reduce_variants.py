"""Variants and launch plans of ``reduce_partials_kernel`` (the last launch
of ``blk_bwd`` and ``wide_bwd``), timed side by side on one card.

    python3 probav_tpu_torch/tools/reduce_variants.py [--variants a,b] \\
        [--shapes blk_bwd,wide_bwd] [--no-sweep] [--out DIR]

Each variant is the reduce's section of ``csrc/blk_bwd.cu`` (from
``constexpr int RED_TILE`` to its launcher, ``reduce_partials``) with the
text substitutions of ``VARIANTS`` (``kernel`` is the section as it is), in
a namespace of its own; all are compiled into one library by nvcc
(``wgrad_variants.compile_variants``, with ptxas's register report),
beside ``column_kernel``, the first design (one thread a float, 4-byte
loads, every slot in order, slots ``len`` apart).  For each shape of
``SHAPES`` (G slots of len floats ``tstack.slot_stride`` apart, random
normal partials from a torch generator, seed 12, NaN pad columns): each
variant at its own plan (``reduce_plan``), and, unless ``--no-sweep``, the
shipped kernel at each (ranks, warps) of the shape's sweep.  For each run:
device time from profiler traces of 10 rounds, warm (a fill of the
partial buffer with a constant, which leaves it in L2, then the reduce)
and cold (a 256 MiB scrub of L2, then the reduce); the plan; the error
against ``torch.sum(part[:, :len], 0)`` over max|ref|; whether two
launches give the same bits.  ``torch.sum`` is timed alike, and the DRAM
bound, 4 (G + 1) len bytes at 3.35 TB/s (``tstack_roofline.reduce_costs``),
given beside.  Prints one JSON line a shape, also appended to
``DIR/reduce_variants.jsonl`` with ``--out``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

_LOAD = ("__device__ __forceinline__ float4 load_part(const float4* p) {\n"
         "  return __ldcs(p);\n}")
# name: ((old, new), ...) applied to the reduce's section.
VARIANTS = {
    "kernel": (),
    # Loads through the read-only path (ld.global.nc), not as a stream.
    "ldg": ((_LOAD, _LOAD.replace("__ldcs", "__ldg")),),
    "ahead4": (("RED_AHEAD = 8;", "RED_AHEAD = 4;"),),
    "ahead16": (("RED_AHEAD = 8;", "RED_AHEAD = 16;"),),
}
# The first design, for reference: one thread a float, every slot in order.
COLUMN_KERNEL = """
__global__ void column_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int G, long len) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[(long)g * len + i];
    out[i] = s;
  }
}
"""
# name: (G, len, [(ranks, warps), ...] swept): blk_bwd's slots at the
# flagship (two a SM), wide_bwd's one wave there, a slot at 128/1024/102.
SHAPES = {
    "blk_bwd": (264, 36_505, [(1, 4), (1, 8), (2, 4), (2, 7), (4, 4),
                              (8, 8)]),
    "wide_bwd": (132, 14_873, [(1, 8), (2, 4), (3, 6), (5, 6), (8, 8)]),
    "c128": (132, 589_286, [(1, 1), (1, 4), (1, 8), (2, 4)]),
}
SECTION = ("constexpr int RED_TILE",
           "// cudaErrorInvalidValue, before any launch, where reduce_takes")


def source(names) -> str:
    """One .cu: each variant's copy of the reduce's section in namespace
    v<i>, ``column_kernel``, and an extern "C" ``launch(v, part, out, G,
    len, stride, ranks, warps, plan, stream)``: variant v at its own plan
    where ranks is 0, else at (ranks, warps); v = -1 runs column_kernel
    (slots len apart); plan[0..2] receives tiles, ranks, warps."""
    from probav_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    sec = text[text.index(SECTION[0]):text.index(SECTION[1])]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "#include <cooperative_groups.h>",
             "namespace {", "namespace cg = cooperative_groups;"]
    cases = []
    for i, name in enumerate(names):
        body = sec
        for old, new in VARIANTS[name]:
            body, hits = re.subn(re.escape(old), new, body)
            if not hits:
                raise ValueError(f"variant {name}: {old!r} not in the "
                                 "reduce")
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"""  if (v == {i}) {{
    const v{i}::ReducePlan q = ranks
        ? v{i}::ReducePlan{{(int)((len + v{i}::RED_TILE - 1) /
                                 v{i}::RED_TILE), ranks, warps}}
        : v{i}::reduce_plan(G, len, probav::sm_count());
    v{i}::ReduceLaunch l(q, s);
    plan[0] = q.tiles;
    plan[1] = q.ranks;
    plan[2] = q.warps;
    const cudaError_t e = cudaLaunchKernelEx(
        &l.cfg, v{i}::reduce_partials_kernel, (const float*)part,
        (float*)out, G, len, stride, q.ranks);
    if (e != cudaSuccess) {{
      cudaGetLastError();
      return (int)e;
    }}
    return (int)cudaGetLastError();
  }}""")
    parts += [COLUMN_KERNEL, "}  // namespace",
              'extern "C" int launch(int v, const void* part, void* out, '
              "int G, long len, long stride, int ranks, int warps, "
              "int* plan, void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases,
              "  if (v == -1) {",
              "    column_kernel<<<(int)std::min<long>((len + 255) / 256, "
              "1024), 256, 0, s>>>((const float*)part, (float*)out, G, len);",
              "    return (int)cudaGetLastError();",
              "  }",
              "  return -1;", "}"]
    return "\n".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    names, shapes = opt.variants.split(","), opt.shapes.split(",")
    if not set(names) <= set(VARIANTS) or not set(shapes) <= set(SHAPES):
        raise SystemExit(f"--variants: a comma list of {', '.join(VARIANTS)}"
                         f"; --shapes: of {', '.join(SHAPES)}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.tools.tstack_roofline import (card_line, kernel_ms,
                                                        reduce_costs)
    from probav_tpu_torch.tools.wgrad_variants import compile_variants
    if not torch.cuda.is_available():
        raise SystemExit("reduce_variants needs a CUDA card")
    card = card_line()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib, regs, spills = compile_variants(
        source(names), "reduce_partials_kernel", names,
        [I, P, P, I, L, L, I, I, ctypes.POINTER(I), P])
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scrub = torch.zeros((256 << 20) // 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    plan = (I * 3)()
    for shape in shapes:
        groups, n, sweep = SHAPES[shape]
        stride = ts.slot_stride(n)
        part = torch.full((groups, stride), float("nan"), device=dev)
        part[:, :n] = torch.randn(groups, n, generator=gen, device=dev)
        want = torch.sum(part[:, :n], 0)
        out = torch.empty(n, device=dev)
        fill = part.clone()

        def run(v, ranks, warps):
            err = lib.launch(v, part.data_ptr(), out.data_ptr(), groups, n,
                             stride, ranks, warps, plan, stream)
            if err:
                raise RuntimeError(f"{shape} v{v} ({ranks}, {warps}): CUDA "
                                   f"error {err}")

        def times(call, name):
            warm = kernel_ms(torch, lambda: (part.fill_(0.5), call()),
                             need=(name,))
            cold = kernel_ms(torch, lambda: (scrub.add_(1.0), call()),
                             need=(name,))
            return tuple(sum(ms for k, ms in t.items() if name in k)
                         for t in (warm, cold))

        plain = lambda: torch.sum(part[:, :n], 0)
        sw, sc = times(plain, "reduce_kernel")
        result = dict(card=card, shape=shape, groups=groups, len=n,
                      stride=stride, torch_sum_warm_ms=sw,
                      torch_sum_cold_ms=sc,
                      bound_ms=reduce_costs(groups, n)["bound_ms"],
                      registers=regs, spill_bytes=spills, runs=[])
        runs = [(i, 0, 0) for i in range(len(names))]
        if not opt.no_sweep and "kernel" in names:
            runs += [(names.index("kernel"), r, w) for r, w in sweep]
        for v, ranks, warps in runs + [(-1, 0, 0)]:
            part.copy_(fill)
            if v >= 0:
                run(v, ranks, warps)
                first = out.clone()
                run(v, ranks, warps)
                torch.cuda.synchronize()
                err = float((first - want).abs().max() / want.abs().max())
                row = dict(variant=names[v], plan=list(plan), rel_err=err,
                           same_bits=bool(torch.equal(first, out)))
            else:
                row = dict(variant="column_kernel")
            row["warm_ms"], row["cold_ms"] = times(
                lambda: run(v, ranks, warps),
                "reduce_partials_kernel" if v >= 0 else "column_kernel")
            result["runs"].append(row)
        line = json.dumps(result)
        print(line, flush=True)
        if opt.out:
            os.makedirs(opt.out, exist_ok=True)
            with open(os.path.join(opt.out, "reduce_variants.jsonl"),
                      "a") as f:
                f.write(line + "\n")
        del part, fill, out, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
