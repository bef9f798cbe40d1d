"""Variants of ``seg_bwd_bf16_kernel`` (the bf16 expand/decay backward of
``blk_bwd`` on the tensor cores), of ``wide_bwd_bf16_kernel`` (the bf16
``wide_bwd``), of ``wide_bwd_tf32_kernel`` (the float32 ``wide_bwd``) or
of ``seg_bwd_tf32_split_kernel`` with ``dx_sum_kernel`` (the float32
expand/decay backward at the 64-filter model's widths), timed side by
side on one card.

    python3 probav_tpu_torch/tools/seg_bwd_variants.py \\
        [--section seg_bwd|wide|wide_tf32|tf32_split] [--variants a,b] \\
        [--rounds 5] [--out DIR]

Each variant is the kernel's section of ``csrc/blk_bwd.cu`` (``SECTIONS``:
for ``seg_bwd``, the default, from ``constexpr int SBB_WARPS`` to the
float32 seg_bwd; for ``wide`` from ``constexpr int WBB_WARPS`` to
``wide_bwd_route``; for ``wide_tf32`` from ``constexpr int SBT_ROWS`` to
the float32 wgrad; for ``tf32_split`` from ``constexpr int STS_WARPS`` to
``seg_bwd_route``) with the text substitutions of its table
(``VARIANTS``, ``WIDE_VARIANTS``, ``WIDE_TF32_VARIANTS`` or
``TF32_SPLIT_VARIANTS``; ``kernel`` is the section as it is), in a
namespace of its own; all are compiled into one library by nvcc
(``wgrad_variants.compile_variants``, with ptxas's register and spill
report; ``tf32_split`` with the pieces of the bf16 split section it
calls) and launched at the train step's rows (N = 557,568), at the
flagship's widths (32/256/25; ``tf32_split`` at 64/512/51, with the
scratch of dx's parts that blk_bwd gives it), into the G partial slots
that blk_bwd or wide_bwd gives them, on inputs and weights in the
section's dtype (bf16, float32 for ``wide_tf32`` and ``tf32_split``) on
the dyadic grids of ``tools/dyadic.py`` (numpy seed 12): x, dd, gy for
the seg_bwd sections, x, dy for the wide sections.  For
each: its registers and spilled bytes, the ms per launch of 20 launches
back to back (CUDA events) in ``--rounds`` rounds taken in turn across
the variants, and the largest error over max|ref| of its dx and of its
summed slots (those written: all G for seg_bwd, the wide launchers' one
wave, which they report; dW1, db1, dW2, db2, and dbc for seg_bwd) against
``tstack.seg_bwd_plain`` or ``wide_block.wide_bwd_plain``.  Variants that
drop work give wrong results by design.  Prints one JSON line, also
appended to ``DIR/seg_bwd_variants.jsonl`` with ``--out``.  Needs a CUDA
card.
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

# The 64-row layouts of wide_bwd_bf16_kernel, which the shipped 128-row
# layout replaced, as substitutions.  At 64 rows two warps share each
# 16-row group in phase C, each for 16 of dx's 32 columns, so phase C's
# rows, columns and k-steps are split in general terms.
_PHASE_C_64 = r"""  constexpr int WPR = WBB_WARPS / RG;          // phase-C warps a row group
  constexpr int CTW = 4 / WPR;                 // their 8-column tiles of dx
  constexpr int KPG = 16 / RG;                 // phase-C k-steps a row group
  static_assert(WPR * RG == WBB_WARPS && CTW % 2 == 0 && KPG * RG == 16,
                "phase C's rows, columns and k-steps per warp");
  const int pr0 = 16 * (warp % RG);          // this warp's phase-C rows
  const int ct0 = CTW * (warp / RG);         // and 8-column tiles of dx
  float dxc[CTW][4];
  // Phase C, k-steps ks0 .. ks0 + nks - 1 of dx = dz W1^T for rows pr0 ..
  // pr0 + 15 and this warp's dx tiles, from the dz buffer z.
  const int zoff = (pr0 + lane % 8) * ZS + 4 * (lane / 8);
  const E* wp = w1s + (8 * ((lane / 8) % 2) + 4 * (lane % 2) +
                       (lane % 8) / 2) * CS + 8 * (ct0 + lane / 16);
  auto phase_c = [&](const float* z, int ks0, int nks) {
#pragma unroll
    for (int kk = 0; kk < nks; ++kk) {
      const int ks = ks0 + kk;
      uint32_t r[4], s[4], a[3][4], b[CTW / 2][4];
      ldsm_x4(r, z + zoff + 16 * ks);
      ldsm_x4(s, z + zoff + 8 * ZS + 16 * ks);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        split3_bf16x2(__uint_as_float(r[2 * i]), __uint_as_float(r[2 * i + 1]),
                      a[0][2 * i], a[1][2 * i], a[2][2 * i]);
        split3_bf16x2(__uint_as_float(s[2 * i]), __uint_as_float(s[2 * i + 1]),
                      a[0][2 * i + 1], a[1][2 * i + 1], a[2][2 * i + 1]);
      }
#pragma unroll
      for (int p = 0; p < CTW / 2; ++p)
        ldsm_x4_trans(b[p], wp + ks * 16 * CS + 16 * p);
#pragma unroll
      for (int pc = 2; pc >= 0; --pc)
#pragma unroll
        for (int p = 0; p < CTW / 2; ++p) {
          mma_bf16(dxc[2 * p], a[pc], b[p][0], b[p][1]);
          mma_bf16(dxc[2 * p + 1], a[pc], b[p][2], b[p][3]);
        }
    }
  };
  auto epilogue = [&](long t) {
    const int nrw = min(16, rows_of(t) - pr0);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CTW; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dxs + (pr0 + g + 8 * hh) * CS +
                                     8 * (ct0 + c) + 2 * q) =
            pack_bf16(dxc[c][2 * hh], dxc[c][2 * hh + 1]);
    __syncwarp();
    E* dst = dx + (t * ROWS + pr0) * c_in;
    if (vec) {
      for (int e = lane; e < 16 * CTW; e += 32) {
        const int r = e / CTW, c = 8 * (ct0 + e % CTW);
        if (r < nrw && c < c_in)
          *reinterpret_cast<uint4*>(dst + r * c_in + c) =
              *reinterpret_cast<const uint4*>(dxs + (pr0 + r) * CS + c);
      }
    } else {
      for (int e = lane; e < 16 * 8 * CTW; e += 32) {
        const int r = e / (8 * CTW), c = 8 * ct0 + e % (8 * CTW);
        if (r < nrw && c < c_in) dst[r * c_in + c] = dxs[(pr0 + r) * CS + c];
      }
    }
  };

"""
_PHASE_C_LOOP = "for (int kp = 0; kp < 8; ++kp) phase_c(kp);"
_LAST_PHASE_C = r"""  if (prev >= 0) {   // the last tile's phase C and epilogue
    __syncthreads();   // its dz complete
#pragma unroll
    for (int t = 0; t < CTW; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 1
    for (int rg = 0; rg < RG; ++rg)
      phase_c(zb + (buf ^ 1) * ROWS * ZS, rg * KPG, KPG);
    epilogue(prev);
  }
"""


def _rows64(beside):
    """Substitutions giving the wide kernel 64-row tiles, with phase C split
    over two warps a row group: with `beside`, two dz buffers (184,576 B)
    and each tile's phase C run beside the next tile's products, else one
    buffer and phase C after the tile's products."""
    subs = [(r"constexpr int WBB_ROWS = \d+;", "constexpr int WBB_ROWS = 64;"),
            (r"  static_assert\(RG == WBB_WARPS, [^;]*;\n", ""),
            (r"  const int pr0 = 16 \* warp;.*?(?=  if \(blockIdx\.x < tiles\))",
             lambda m: _PHASE_C_64),
            (r"(for \(int t = 0; t < )4(; \+\+t\)\n\s+dxc\[t\]\[0\])",
             r"\1CTW\2")]
    if not beside:
        return tuple(subs) + ((re.escape(_PHASE_C_LOOP), "for (int rg = 0; "
                               "rg < RG; ++rg) phase_c(zb, rg * KPG, KPG);"),)
    return tuple(subs) + (
        (r"\(size_t\)WBB_ROWS \* WBB_ZS", "(size_t)2 * WBB_ROWS * WBB_ZS"),
        (r"zb \+ ROWS \* ZS\);", "zb + 2 * ROWS * ZS);"),
        (r"  int buf = 0;\n", "  int buf = 0;\n  long prev = -1;\n"),
        (r"(    const E\* dt = dyt \+ buf \* ROWS \* CS;\n)",
         r"\1    float* zw = zb + buf * ROWS * ZS;\n"),
        (r"float\* zp = zb \+", "float* zp = zw +"),
        # The previous tile's phase C beside this tile's products (at a
        # block's first tile it reads the other buffer, and nothing of it
        # is stored).
        (r"(\n#pragma unroll\n      for \(int mt = 0; mt < MT; \+\+mt\) \{\n"
         r"        // C tile)",
         r"\n      phase_c(zb + (buf ^ 1) * ROWS * ZS, rg * KPG, KPG);\1"),
        (r"    __syncthreads\(\);   // this tile's dz complete\n.*?"
         r"epilogue\(tile\);\n", "    if (prev >= 0) epilogue(prev);\n"),
        (r"(rows_of\(next\)\);\n    \}\n)", r"\1    prev = tile;\n"),
        (r"(  probav::cp_async_wait_all\(\);\n\n  // Write)",
         lambda m: _LAST_PHASE_C + m.group(1)))


_SPLIT_TRUNC = r"""  const uint32_t u0 = __float_as_uint(v0), u1 = __float_as_uint(v1);
  hi = __byte_perm(u0, u1, 0x7632);
  const float r0 = v0 - __uint_as_float(u0 & 0xffff0000u);
  const float r1 = v1 - __uint_as_float(u1 & 0xffff0000u);
  const uint32_t s0 = __float_as_uint(r0), s1 = __float_as_uint(r1);
  mid = __byte_perm(s0, s1, 0x7632);
  lo = __byte_perm(__float_as_uint(r0 - __uint_as_float(s0 & 0xffff0000u)),
                   __float_as_uint(r1 - __uint_as_float(s1 & 0xffff0000u)),
                   0x7632);
"""

# name: ((pattern, replacement), ...) applied to wide_bwd_bf16_kernel's
# section.
WIDE_VARIANTS = {
    "kernel": (),
    # 64-row tiles with two dz buffers: phase C beside the next tile's
    # products, one barrier a tile, as in seg_bwd_bf16_kernel, but each
    # warp's phase C covers 16 columns, so every dz value is loaded and
    # split twice.  Two 128-row buffers do not fit.
    "rows64": _rows64(beside=True),
    # 64-row tiles, one dz buffer: phase C after the products.
    "rows64_after": _rows64(beside=False),
    # Phases removed: every mma (operands still loaded and kept live),
    # phase C, the dz stores, every tile (the block's set-up and slot).
    "no_mma": ((r"\bmma_bf16\(", "fake_mma("),),
    "no_phase_c": ((re.escape(_PHASE_C_LOOP), "(void)0;"),),
    "no_dz_store": ((r"zp\[0\] = dz0;\s*zp\[ZS\] = dz1;", "(void)zp;"),),
    "no_tiles": ((r"for \(long tile = blockIdx.x; tile < tiles;",
                  "for (long tile = tiles; tile < tiles;"),),
    # One or two bf16 pieces of each float32 operand (wrong by design: one
    # piece rounds dz and relu(z) to bf16 once): the products' loops over
    # the pieces start at hi or at mid.
    "split1": ((r"for \(int pc = 2;", "for (int pc = 0;"),),
    "split2": ((r"for \(int pc = 2;", "for (int pc = 1;"),),
    # The pieces cut by truncation (the top 16 bits of each float32, by
    # byte permutes) instead of rounding: as exact a split (the last
    # remainder still fits 8 bits), cheaper instructions.
    "split_trunc": ((r"  hi = pack_bf16\(v0, v1\);\n.*?0xffff0000u\)\);\n",
                     _SPLIT_TRUNC),),
    # The 16-row group loop unrolled 2 deep, not 1.
    "unroll_2": ((r"#pragma unroll 1(\s+for \(int rg = 0; rg < RG; \+\+rg\) "
                  r"\{)", r"#pragma unroll 2\1"),),
    # G blocks (2 an SM) in two waves, each re-staging W1, W2 and the
    # fragments, not one wave of one block an SM.
    "g_blocks": ((r"const int G1 = std::min\(G, [^;]*;", "const int G1 = G;"),),
}

# name: ((pattern, replacement), ...) applied to the float32 section
# (seg_bwd_tf32_body, whose WIDE flavour wide_bwd_tf32_kernel is launched).
WIDE_TF32_VARIANTS = {
    "kernel": (),
    # G blocks (one an SM) in two waves, each re-staging the weights, not
    # one wave of min(G, resident) blocks.
    "g_blocks": ((r"const int G1 = std::min\(G, [^;]*;", "const int G1 = G;"),),
    # Phases removed: every mma (operands still split and kept live),
    # phase B (dW1, dW2 and db1: two of the five product sets).
    "no_mma": ((r"\bmma_term\(", "fake_mma_tf32("),),
    "no_phase_b": ((r"for \(int kk = 0; kk < SBT_ROWS / 8; \+\+kk\)",
                    "for (int kk = 0; kk < 0; ++kk)"),),
}

# The float32 split seg_bwd's dx part stores, replaced in the cluster
# variant (each chunk's part to its own block's shared memory; the
# cluster's parts summed in rank order with gy by rows split over the
# ranks, dbc from gy, through distributed shared memory).
_DXP_STORE = r"""    const long row0 = tile \* ROWS;
#pragma unroll
    for \(int hh = 0; hh < 2; \+\+hh\) \{
      const long row = row0 \+ pr0 \+ g \+ 8 \* hh;
      if \(row >= n\) continue;.*?
  probav::cp_async_wait_all\(\);
"""
_CLUSTER_STORE = """    const long row0 = tile * ROWS;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        *reinterpret_cast<float2*>(dxs + (pr0 + g + 8 * hh) * 72 +
                                   8 * (ct0 + t) + 2 * q) =
            make_float2(dxc[t][2 * hh], dxc[t][2 * hh + 1]);
    cluster.sync();   // every chunk's part of the tile in its block
    const int nr = (int)min((long)ROWS, (long)n - row0), cc = tid % 64;
    if (cc < c_in)
      for (int r = chunk + chunks * (tid / 64); r < nr; r += 4 * chunks) {
        float v = 0.f;
        for (int k = 0; k < chunks; ++k)
          v += cluster.map_shared_rank(dxs, k)[r * 72 + cc];
        const long e = (row0 + r) * c_in + cc;
        const float gv = gy[e];
        dbca += gv;
        dx[e] = v + gv;
      }
  }
  probav::cp_async_wait_all();
  dbs[tid] = dbca;
  __syncthreads();
  if (tid < 64) {
    float v = 0.f;
    for (int l = 0; l < 4; ++l) v += dbs[l * 64 + tid];
    dbs[256 + tid] = v;
  }
  cluster.sync();   // the ranks' dbc sums; every read of dxs done
  if (chunk == 0 && tid < c_in) {
    float v = 0.f;
    for (int k = 0; k < chunks; ++k)
      v += cluster.map_shared_rank(dbs, k)[256 + tid];
    part[slot_i * slot_len + Slot(c_in, c_mid, c_dec).bc + tid] = v;
  }
  cluster.sync();   // rank 0 done with the others' dbs
"""
_CLUSTER_LAUNCH = """  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(G * chunks);
  cfg.blockDim = dim3(STS_WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(x),
                           static_cast<const float*>(dd),
                           static_cast<const float*>(w1), b1,
                           static_cast<const float*>(w2), dxp, ldp,
                           static_cast<const float*>(gy),
                           static_cast<float*>(dx), part, slot_len, chunks,
                           n, c_in, c_mid, c_dec);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}
"""

# name: ((pattern, replacement), ...) applied to the float32 split
# section (seg_bwd_tf32_split_kernel and its launcher, which runs
# dx_sum_kernel after it).
TF32_SPLIT_VARIANTS = {
    "kernel": (),
    # Passes of 16 rows (z^T and W2 dd^T of two n-tiles live) instead of
    # 32, or the k-loops not unrolled: fewer registers, more reloads.
    "pass2": ((r"constexpr int STS_PASS = \d+;", "constexpr int STS_PASS = 2;"),),
    "unroll1": ((r"#pragma unroll 2", "#pragma unroll 1"),),
    # Work removed: every mma (operands still split and kept live), the
    # dx parts' stores, dx_sum_kernel (wrong results by design).
    "no_mma": ((r"\bmma_term\(", "fake_mma_tf32("),),
    "no_dxp_store": ((r"\*reinterpret_cast<float2\*>\(dxc_dst \+ row \* ldp \+ c\) =",
                      "if (row < 0) *reinterpret_cast<float2*>(dxc_dst) ="),),
    "no_dx_sum": ((r"  return launch_dx_sum\(dxp, .*?\);\n",
                   "  return cudaSuccess;\n"),),
    # A row tile's chunks as one thread-block cluster (chunks blocks, one
    # a chunk): dx's parts summed through distributed shared memory in
    # chunk order, dx written once, no dx_sum_kernel; two cluster barriers
    # a tile.
    "cluster": (
        (r"float\* __restrict__ dxp, int ldp,",
         "float* __restrict__ dxp, int ldp, const float* __restrict__ gy, "
         "float* __restrict__ dx,"),
        (r"(  float\* red = zt \+ JC \* ZS;[^\n]*\n)",
         r"\1  float* dxs = red + STS_WARPS * STS_CH;   // [ROWS][72]\n"
         "  float* dbs = dxs + ROWS * 72;   // [5][64]\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n"
         "  float dbca = 0.f;\n"),
        (r"__syncthreads\(\);   // this tile staged; the last phase C done "
         r"with dz\^T", "cluster.sync();"),
        (_DXP_STORE, _CLUSTER_STORE),
        (r"STS_WARPS \* STS_CH\);\n\}",
         "STS_WARPS * STS_CH + STS_ROWS * 72 + 5 * 64);\n}"),
        (r"  kern<<<G \* chunks, STS_WARPS \* 32, smem, s>>>\(.*?\n\}\n",
         _CLUSTER_LAUNCH)),
}

# Each section: where it starts and ends in blk_bwd.cu, its kernel and
# launcher, the launcher's arguments, its variants.
SECTIONS = {
    "seg_bwd": dict(start="constexpr int SBB_WARPS",
                    end="// seg_bwd, float32 on the tensor cores",
                    kernel="seg_bwd_bf16_kernel",
                    launcher="launch_seg_bwd_bf16",
                    args="x, dd, gy, w1, b1, w2, dx, part, slot_len, G, n, "
                         "c_in, c_mid, c_dec, s",
                    params="const void* x, const void* dd, const void* gy, "
                           "const void* w1, const float* b1, const void* w2, "
                           "void* dx, float* part, long slot_len, int G, "
                           "int n, int c_in, int c_mid, int c_dec",
                    variants=VARIANTS),
    "wide": dict(start="constexpr int WBB_WARPS",
                 end="// Which kernel wide_bwd runs",
                 kernel="wide_bwd_bf16_kernel",
                 launcher="launch_wide_bwd_bf16",
                 args="x, w1, b1, w2, dy, dx, part, slot_len, G, n, c_in, "
                      "c_mid, c_dec, used, s",
                 params="const void* x, const void* w1, const float* b1, "
                        "const void* w2, const void* dy, void* dx, "
                        "float* part, long slot_len, int G, int n, "
                        "int c_in, int c_mid, int c_dec, int* used",
                 variants=WIDE_VARIANTS),
    "wide_tf32": dict(start="constexpr int SBT_ROWS",
                      end="// wgrad, float32 on the tensor cores",
                      kernel="wide_bwd_tf32_kernel",
                      launcher="launch_wide_bwd_tf32",
                      args="x, w1, b1, w2, dy, dx, part, slot_len, G, n, "
                           "c_in, c_mid, c_dec, used, s",
                      params="const void* x, const void* w1, const float* "
                             "b1, const void* w2, const void* dy, void* dx, "
                             "float* part, long slot_len, int G, int n, "
                             "int c_in, int c_mid, int c_dec, int* used",
                      variants=WIDE_TF32_VARIANTS),
    "tf32_split": dict(start="constexpr int STS_WARPS",
                       end="// Which seg_bwd blk_bwd runs",
                       kernel="seg_bwd_tf32_split_kernel",
                       launcher="launch_seg_bwd_tf32_split",
                       args="x, dd, gy, w1, b1, w2, dx, dxp, part, slot_len, "
                            "G, n, c_in, c_mid, c_dec, s",
                       params="const void* x, const void* dd, const void* "
                              "gy, const void* w1, const float* b1, const "
                              "void* w2, void* dx, float* dxp, float* part, "
                              "long slot_len, int G, int n, int c_in, "
                              "int c_mid, int c_dec",
                       # what it uses of the bf16 split section, cut
                       # from blk_bwd.cu: (start, end) of each piece
                       prelude=(("// Floats of a row of dx's float32 parts.",
                                 "size_t seg_bwd_split_smem()"),
                                ("// dx = T(sum over the chunks of dxp + gy)",
                                 "cudaError_t launch_seg_bwd_split(")),
                       widths=(64, 512, 51), chunk=128,
                       variants=TF32_SPLIT_VARIANTS),
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

__device__ __forceinline__ void fake_mma_tf32(float (&c)[4],
                                              const probav::FragA& a,
                                              const probav::FragB& b,
                                              int term) {
  asm volatile("" : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a.h[0]), "r"(a.h[1]), "r"(a.h[2]), "r"(a.h[3]),
                 "r"(a.l[0]), "r"(a.l[1]), "r"(a.l[2]), "r"(a.l[3]),
                 "r"(b.h[0]), "r"(b.h[1]), "r"(b.l[0]), "r"(b.l[1]),
                 "r"(term));
}
"""


def source(names, section="seg_bwd") -> str:
    """One .cu: blk_bwd.cu's ``using`` declarations, ``Slot`` and the
    helpers, then each variant's copy of the section's kernel in namespace
    v<i>, then an extern "C" ``launch(i, ...)``."""
    from probav_tpu_torch.ops import _build
    sec = SECTIONS[section]
    text = (_build.SRC_DIR / "blk_bwd.cu").read_text()
    slot = text[text.index("struct Slot {"):text.index("};", text.index(
        "struct Slot {")) + 2]
    end = text.index(sec["end"])
    body0 = text[text.index(sec["start"]):
                 text.rindex("\n", 0, text.rindex("\n", 0, end)) + 1]
    usings = [ln for ln in text.splitlines()
              if ln.startswith("using probav::")]
    prelude = ["namespace cg = cooperative_groups;"] + [
        text[text.index(a):text.index(b)] for a, b in sec.get("prelude", ())]
    parts = [f'#include "{_build.SRC_DIR / "common.cuh"}"',
             "#include <algorithm>", "#include <cooperative_groups.h>",
             "namespace {", *usings, slot, FAKE_MMA, *prelude]
    cases = []
    for i, name in enumerate(names):
        body = body0
        for pattern, new in sec["variants"][name]:
            body, hits = re.subn(pattern, new, body, flags=re.S)
            if not hits:
                raise ValueError(f"variant {name}: {pattern!r} not in the "
                                 "kernel")
        parts.append(f"namespace v{i} {{\n{body}}}  // namespace v{i}")
        cases.append(f"  if (v == {i}) return v{i}::{sec['launcher']}("
                     f"{sec['args']});")
    parts += ["}  // namespace",
              f'extern "C" int launch(int v, {sec["params"]}, '
              "void* stream) {",
              "  cudaStream_t s = static_cast<cudaStream_t>(stream);",
              *cases, "  return -1;", "}"]
    return "\n".join(parts)


def slot_offsets(c_in, c_mid, c_dec, conv=True):
    """(w1, w2, b1, b2, bc, len) of blk_bwd.cu's ``Slot``: dWc first; no
    dWc and no dbc without ``conv`` (wide_bwd's slots)."""
    w1 = 27 * c_dec * c_in if conv else 0
    w2 = w1 + c_in * c_mid
    b1 = w2 + c_mid * c_dec
    b2 = b1 + c_mid
    bc = b2 + c_dec
    return w1, w2, b1, b2, bc, bc + (c_in if conv else 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--section", choices=tuple(SECTIONS), default="seg_bwd")
    ap.add_argument("--variants")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    sec = SECTIONS[opt.section]
    table = sec["variants"]
    names = (opt.variants or ",".join(table)).split(",")
    if not set(names) <= set(table):
        raise SystemExit(f"--variants: a comma list of {', '.join(table)}")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import numpy as np
    import torch

    from probav_tpu_torch.ops import tstack as ts
    from probav_tpu_torch.ops import wide_block as wb
    from probav_tpu_torch.tools.dyadic import grid
    from probav_tpu_torch.tools.tstack_roofline import back_to_back
    from probav_tpu_torch.tools.wgrad_variants import compile_variants
    if not torch.cuda.is_available():
        raise SystemExit("seg_bwd_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    P, I = ctypes.c_void_p, ctypes.c_int
    wide = opt.section.startswith("wide")
    c_in, c_mid, c_dec = sec.get("widths", (C, C_MID, C_DEC))
    # pointer arguments before slot_len; the wide launchers' G1 after c_dec
    npt = sec["params"].split("long slot_len")[0].count("*")
    used = ctypes.c_int(0)
    lib, regs, spills = compile_variants(
        source(names, opt.section), sec["kernel"], names,
        [I] + [P] * npt + [ctypes.c_long] + [I] * 5 + [P] * wide + [P])
    dev = torch.device("cuda")
    r = np.random.default_rng(12)
    dtype = torch.float32 if "tf32" in opt.section else torch.bfloat16
    t = lambda a: torch.from_numpy(a).to(dev, dtype)
    x = t(grid(r, (N, c_in), 32, 4))
    if wide:
        dy = t(grid(r, (N, c_dec), 32, 4))
    else:
        dd, gy = t(grid(r, (N, c_dec), 32, 4)), t(grid(r, (N, c_in), 32, 4))
    w1 = t(grid(r, (c_in, c_mid), 16, 6))
    w2 = t(grid(r, (c_mid, c_dec), 8, 5))
    b1 = torch.from_numpy(grid(r, (c_mid,), 16, 6)).to(dev)
    if wide:
        ref = wb.wide_bwd_plain(x, w1, b1, w2, dy)
        ins = (x, w1, b1, w2, dy)
    else:
        ref = ts.seg_bwd_plain(x, dd, gy, w1, b1, w2)
        ins = (x, dd, gy, w1, b1, w2)
    groups = ts.partial_slots(dev, c_in, c_dec)
    o1, o2, ob1, ob2, obc, slot_len = slot_offsets(c_in, c_mid, c_dec,
                                                   conv=not wide)
    part = torch.empty(groups, slot_len, device=dev)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # dx's float32 parts: the chunks of C_mid x N x c_in rounded up to 8
    dxp = [torch.empty(-(-c_mid // sec["chunk"]) * N * -(-c_in // 8) * 8,
                       device=dev)] if "chunk" in sec else []
    ptrs = [a.data_ptr() for a in ins] + [dx.data_ptr()] + \
        [a.data_ptr() for a in dxp] + [part.data_ptr()]

    def call(i):
        err = lib.launch(i, *ptrs, slot_len, groups, N, c_in, c_mid, c_dec,
                         *[ctypes.byref(used)] * wide, stream)
        if err:
            raise RuntimeError(f"variant {names[i]}: CUDA error {err}")

    def rel(a, b):
        b = b.double()
        return float((a.double() - b).abs().max() / b.abs().max())

    result = dict(card=card, section=opt.section, n=N,
                  widths=[c_in, c_mid, c_dec], groups=groups, variants={})
    for i, name in enumerate(names):
        dx.fill_(float("nan"))
        part.fill_(float("nan"))
        call(i)
        torch.cuda.synchronize()
        # the slots written: all G, or the wide launchers' one wave
        s = part[:used.value if wide else groups].double().sum(0)
        got = (dx, s[o1:o2].reshape(c_in, c_mid), s[ob1:ob2],
               s[o2:ob1].reshape(c_mid, c_dec), s[ob2:obc], s[obc:])
        if wide:   # wide_bwd_plain's order: dx, dW1, db1, dW2, db2
            got = got[:5]
        errs = [rel(a, b) for a, b in zip(got, ref)]
        result["variants"][name] = dict(
            registers=regs.get(name), spill_bytes=spills.get(name), ms=[],
            dx_rel_err=errs[0], grads_rel_err=max(errs[1:]))
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
        with open(os.path.join(opt.out, "seg_bwd_variants.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
