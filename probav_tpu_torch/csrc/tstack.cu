// Hand-written Hopper kernels for the WDSR-B block stack forward.
//
// They replace the two TPU kernels that every forward block of the serving
// path runs (probav_tpu/ops/pallas_tstack.py):
//
//   seg_fwd  (pallas_tstack.py:228-266)  d = W2^T relu(W1^T x + b1) + b2
//   conv_fwd (pallas_tstack.py:273-318)  out = x + bc + conv3d_SAME(d, wc)
//
// The TPU kernels work on a transposed, lane-shifted [C, ext] layout.  Here
// activations stay in the model's channels-last [B, H, W, T, C] layout, so
// a block is a set of [N, C] rows with no pad lanes and no interior mask;
// the conv's ragged (H, W, T) edges are zero borders of staged halo rows.
//
// What bounds them on an H100: seg_fwd is 2*(C_in*C_mid + C_mid*C_dec)
// FLOP per row (29,184 at the flagship's 32/256/25) against a few dozen
// elements of traffic per row, compute-bound once the [N, C_mid] wide
// activation never reaches device memory -- the point of the TPU kernel,
// kept here: at the flagship's N = 557,568, 0.0987 ms of 3xTF32 products
// at the TF32 peak in float32 (0.2429 ms on the CUDA cores), 0.019 ms of
// bytes in bf16.  conv_fwd at the flagship (128 patches of 22x22x9, 25 -> 32:
// N = 557,568 positions) reads d (27.9 MB) and x (35.7 MB) and writes out
// (35.7 MB): 99 MB, 0.0296 ms at 3.35 TB/s; its 24.1 GFLOP (30.8 with the
// decay channels padded to 32) take 0.024 ms at the bf16 tensor peak, so
// in bf16 it is bound by bytes, and in float32 (0.36 ms at 67 TFLOP/s) by
// operations.
//
// - seg_fwd, float32, runs on the tensor cores as 3xTF32 where their tiles
//   cover the widths (c_in, c_dec <= 32, c_mid <= 256: the flagship's;
//   seg_fwd_route): seg_fwd_tf32_kernel, mma.sync m16n8k8 on split
//   operands, the expand and decay products chained in registers, float32
//   sums (within the float32 tolerance of the JAX reference's exact
//   products).  Up to c_in, c_dec <= 64 and c_mid <= 512 (the 64-filter
//   model's 64/512/51) seg_fwd_tf32_wide_kernel does the same with C_mid
//   staged in chunks.  At wider widths it runs on the CUDA cores with exact
//   float32 products (seg_fwd_kernel): each thread owns one row, holds
//   the d accumulator (and, up to 64 + 64 channels, x) in registers and
//   makes the wide activation one channel at a time; weights are staged
//   in shared memory in chunks of SEG_MCH middle channels and read as
//   broadcast float4 loads.
// - seg_fwd, bf16, runs on the tensor cores (mma.sync m16n8k16, float32
//   accumulators) and chains the expand and decay products in registers.
//   Within the widths of the float32 tensor-core route it runs
//   seg_fwd_bf16_kernel: x tiles staged by cp.async, weight fragments by
//   ldmatrix reused over each warp's row tiles, d stored as contiguous
//   spans.  Up to c_in, c_dec <= 64 and c_mid <= 512 (64/512/51)
//   seg_fwd_bf16_wide_kernel does the same with all the weights staged
//   once a block by a persistent grid; wider, seg_fwd_mma_kernel.
//
// Every kernel takes C and C_dec from 1 to 128 (probav::MAX_CH), in
// 32-channel buckets of its compile-time widths (probav::by_bucket).
// - conv_fwd, both dtypes, is an implicit GEMM on the tensor cores over a
//   shared-memory ring of halo rows, cut into runs of columns where whole
//   rows do not fit, each row of d read from memory about once, filled by
//   cp.async while the tensor cores work, fragments by ldmatrix
//   (conv_ring_kernel below, with its shared-memory budget and shape
//   envelope): bf16 products at bf16, float32 products as 3xTF32 (three
//   TF32 products of split operands, within the float32 tolerance).
//   blk_bwd.cu's dd conv runs the same kernel through probav::conv_dispatch.
//
// Both round where the TPU kernels round: sums in float32, the relu output
// cast to the compute dtype before the decay product, outputs stored in
// the compute dtype.  wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (probav_tpu_torch/ops/_build.py):
// every entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the call that failed first).

#include "common.cuh"

#include <algorithm>
#include <initializer_list>
#include <type_traits>

namespace {

using probav::copy_async;
using probav::copy_rows;
using probav::cp_async_commit;
using probav::cp_async_wait_all;
using probav::FragA;
using probav::FragB;
using probav::ldsm_x4;
using probav::ldsm_x4_trans;
using probav::lds32;
using probav::mma_bf16;
using probav::mma_term;
using probav::mma_tf32;
using probav::pack2;
using probav::pack_bf16;
using probav::relu_bf16x2;
using probav::run_buf_bytes;
using probav::sm_count;
using probav::split_a;
using probav::split_b;
using probav::split_tf32;
using probav::store_span_warp;

constexpr int SEG_ROWS = 256;   // rows per seg_fwd block = threads per block
constexpr int SEG_MCH = 64;     // middle channels staged per chunk

// ------------------------------------------------------------------------ //
// seg_fwd, float32: x [n, c_in] -> d [n, c_dec]                             //
// CI, CD: the 32-channel buckets of c_in, c_dec; unused lanes see zero      //
// weights.  The d accumulator lives in registers; so does the x row where   //
// both fit (CI + CD <= 128), else each thread reads its x row from the      //
// shared tile (odd stride: no bank conflicts), four middle channels per     //
// pass over it, unrolled 4 deep.  The sums run in the same order either     //
// way.                                                                     //
// ------------------------------------------------------------------------ //

template <int CI, int CD>
__global__ void __launch_bounds__(SEG_ROWS)
seg_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ d, int n,
               int c_in, int c_mid, int c_dec) {
  constexpr int RS = (CI > CD ? CI : CD) + 1;   // odd row stride: no bank
                                                // conflicts across rows
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                    // [SEG_MCH][CI]  (w1 transposed)
  float* w2s = w1s + SEG_MCH * CI;      // [SEG_MCH][CD]
  float* b1s = w2s + SEG_MCH * CD;      // [SEG_MCH]
  float* rows = b1s + SEG_MCH;          // [SEG_ROWS][RS]  x in, d out

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * SEG_ROWS;
  const long left = (long)n - row0;
  const int nrows = left < SEG_ROWS ? (int)left : SEG_ROWS;

  // Coalesced load of the x tile; zero beyond c_in and beyond n.
  for (int e = tid; e < SEG_ROWS * CI; e += SEG_ROWS) {
    const int r = e / CI, k = e % CI;
    float v = 0.f;
    if (r < nrows && k < c_in) v = x[(row0 + r) * c_in + k];
    rows[r * RS + k] = v;
  }
  __syncthreads();

  constexpr bool XREG = CI + CD <= 128;
  float xr[XREG ? CI : 1];
  if constexpr (XREG) {
#pragma unroll
    for (int k = 0; k < CI; ++k) xr[k] = rows[tid * RS + k];
  }
  const float* xo = rows + tid * RS;   // this thread's x row
  float acc[CD];
#pragma unroll
  for (int c = 0; c < CD; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < c_mid; j0 += SEG_MCH) {
    __syncthreads();   // previous chunk fully consumed (and x tile read)
    // w1 [c_in, c_mid] -> w1s[j][k]; consecutive threads read consecutive j.
    for (int e = tid; e < SEG_MCH * CI; e += SEG_ROWS) {
      const int k = e / SEG_MCH, j = e % SEG_MCH;
      float v = 0.f;
      if (k < c_in && j0 + j < c_mid) v = w1[(long)k * c_mid + j0 + j];
      w1s[j * CI + k] = v;
    }
    for (int e = tid; e < SEG_MCH * CD; e += SEG_ROWS) {
      const int j = e / CD, c = e % CD;
      float v = 0.f;
      if (c < c_dec && j0 + j < c_mid) v = w2[(long)(j0 + j) * c_dec + c];
      w2s[j * CD + c] = v;
    }
    for (int j = tid; j < SEG_MCH; j += SEG_ROWS)
      b1s[j] = (j0 + j < c_mid) ? b1[j0 + j] : 0.f;
    __syncthreads();

    // acc += relu(x w1[:, j] + b1[j]) w2[j, :].  Padded channels have zero
    // weights and bias: they contribute nothing.
    auto decay = [&](float h, int j) {
      const float4* w2v = reinterpret_cast<const float4*>(w2s + j * CD);
#pragma unroll
      for (int q = 0; q < CD / 4; ++q) {
        const float4 w = w2v[q];
        acc[4 * q + 0] = fmaf(h, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
      }
    };
    if constexpr (XREG) {
#pragma unroll 2
      for (int j = 0; j < SEG_MCH; ++j) {
        const float4* w1v = reinterpret_cast<const float4*>(w1s + j * CI);
        float z = 0.f;
#pragma unroll
        for (int q = 0; q < CI / 4; ++q) {
          const float4 w = w1v[q];
          z = fmaf(xr[4 * q + 0], w.x, z);
          z = fmaf(xr[4 * q + 1], w.y, z);
          z = fmaf(xr[4 * q + 2], w.z, z);
          z = fmaf(xr[4 * q + 3], w.w, z);
        }
        decay(fmaxf(z + b1s[j], 0.f), j);
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < SEG_MCH; j += 4) {
        float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int k = 0; k < CI; k += 4) {
          const float xv[4] = {xo[k], xo[k + 1], xo[k + 2], xo[k + 3]};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 w =
                *reinterpret_cast<const float4*>(w1s + (j + u) * CI + k);
            z[u] = fmaf(xv[0], w.x, z[u]);
            z[u] = fmaf(xv[1], w.y, z[u]);
            z[u] = fmaf(xv[2], w.z, z[u]);
            z[u] = fmaf(xv[3], w.w, z[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) decay(fmaxf(z[u] + b1s[j + u], 0.f), j + u);
      }
    }
  }

  __syncthreads();   // every thread is done with its x row in `rows`
#pragma unroll
  for (int c = 0; c < CD; ++c)
    rows[tid * RS + c] = acc[c] + (c < c_dec ? b2[c] : 0.f);
  __syncthreads();
  for (int e = tid; e < nrows * c_dec; e += SEG_ROWS) {
    const int r = e / c_dec, c = e % c_dec;
    d[(row0 + r) * c_dec + c] = rows[r * RS + c];
  }
}

template <int CI, int CD>
cudaError_t launch_seg(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* d, int n,
                       int c_in, int c_mid, int c_dec, cudaStream_t stream) {
  constexpr int RS = (CI > CD ? CI : CD) + 1;
  const size_t smem =
      sizeof(float) * (SEG_MCH * CI + SEG_MCH * CD + SEG_MCH + SEG_ROWS * RS);
  auto kern = seg_fwd_kernel<CI, CD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n + SEG_ROWS - 1) / SEG_ROWS;
  kern<<<grid, SEG_ROWS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(d), n, c_in, c_mid,
      c_dec);
  return cudaGetLastError();
}

cudaError_t dispatch_seg(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* d, int n,
                         int c_in, int c_mid, int c_dec, cudaStream_t s) {
  return probav::by_bucket(c_in, [&](auto ci) {
    return probav::by_bucket(c_dec, [&](auto cd) {
      return launch_seg<decltype(ci)::value, decltype(cd)::value>(
          x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
    });
  });
}

// ------------------------------------------------------------------------ //
// seg_fwd, float32, on the tensor cores as 3xTF32 (mma.sync m16n8k8):       //
// seg_fwd_tf32_kernel, for c_in, c_dec <= 32 and c_mid <= 256               //
// (seg_fwd_route; the flagship's 32/256/25).                                //
// ------------------------------------------------------------------------ //
//
// - Tiles: a persistent grid walks tiles of SFT_ROWS = 192 rows; warp w of
//   12 (three on each of the SM's four schedulers) owns rows 16 w .. 16 w
//   + 15 of each.  x tiles are double-buffered: the next
//   tile's rows arrive by cp.async (copy_rows: 16 bytes where c_in % 4 ==
//   0 and x is 16-byte aligned, else 4; zeros past n) while this one
//   computes, and one barrier a tile guards both buffers.
// - Weights: W1 and W2 staged once per block as [c][j] planes (W2
//   transposed), zero-padded to 32 x 256, row stride SFT_WS = 264 (8 mod
//   32 banks), so every B fragment load is conflict-free; split at each
//   load (as seg_bwd_tf32_kernel does).
// - Expand: x's A fragments (rows g, g + 8; columns q, q + 4 of each of the
//   four k-steps, zero from c_in on) are split once a tile.  Per pair of
//   8-column n-tiles of C_mid: z = x W1 as three products (hi hi, lo hi,
//   hi lo; lo lo dropped), + b1, h = relu(z).
// - Decay, chained in registers: C columns 2q, 2q + 1 of h are the A
//   columns q, q + 4 of the decay's k-step, and W2's B rows are read in the
//   same order (a float2 at [c][j + 2q]): the order of k inside a dot
//   product is free.  d (C_dec padded to 32: four n-tiles) += h W2.
// - Sums: the tensor cores sum with truncation, so each 64-channel chunk's
//   decay products go to fresh accumulators, added in float32 to the
//   running d sums.
// - Epilogue: + b2; each warp stages its 16 rows of d in its own rows of
//   the x buffer it has read (x's padding columns are never read: the
//   fragments mask them), then stores its c_dec real columns, a contiguous
//   run of 16 c_dec floats, coalesced; nothing past n.
// - Shared memory: 2 x 33,792 (w1, w2) + 1,152 (b1, b2) + 2 x 30,720 (x
//   tiles): 130,176 B, one block an SM, 152 registers.  Measured against
//   two blocks of 8 warps an SM (109,696 B each, 127 registers), one of
//   8 and one of 16 (tools/seg_fwd_variants.py): 12 warps were the
//   fastest, and at the flagship's N its 2,904 tiles split evenly over 132
//   SMs; the chunk's four pairs of n-tiles fully unrolled beat two.
//
// What bounds it on an H100: 2 (c_in c_mid + c_mid c_dec) FLOP a row,
// 16.27 GFLOP at the flagship's N = 557,568, three TF32 products each:
// 0.0987 ms at the 494.7 TFLOP/s TF32 peak (0.2429 ms at the CUDA cores'
// 67 TFLOP/s), against 127 MB of x and d (0.038 ms): operations.  It
// issues C_dec padded to 32 (1.28x the decay's products), on mma.sync,
// which issues near half the TF32 rate.

constexpr int SFT_WARPS = 12;                  // 16 rows each
constexpr int SFT_MINB = 1;                    // blocks per SM
constexpr int SFT_ROWS = 16 * SFT_WARPS;       // rows per tile
constexpr int SFT_CH = 64;                     // middle channels per chunk
constexpr int SFT_XS = 40;                     // x (and d) tile row stride
constexpr int SFT_WS = 256 + 8;                // [c][j] weight row stride

__global__ void __launch_bounds__(SFT_WARPS * 32, SFT_MINB)
seg_fwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ d,
                    int n, int c_in, int c_mid, int c_dec) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                            // [32][WS]  w1[c][j]
  float* w2s = w1s + 32 * SFT_WS;               // [32][WS]  w2[j][c] at [c][j]
  float* b1s = w2s + 32 * SFT_WS;               // [256]
  float* b2s = b1s + 256;                       // [32]
  float* xb = b2s + 32;                         // [2][ROWS][XS]  x tiles
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;

  for (int e = tid; e < 32 * 256; e += blockDim.x) {
    const int c = e / 256, j = e % 256;
    w1s[c * SFT_WS + j] = (c < c_in && j < c_mid) ? w1[(long)c * c_mid + j]
                                                  : 0.f;
    const int j2 = e / 32, c2 = e % 32;
    w2s[c2 * SFT_WS + j2] =
        (c2 < c_dec && j2 < c_mid) ? w2[(long)j2 * c_dec + c2] : 0.f;
  }
  for (int j = tid; j < 256; j += blockDim.x) b1s[j] = j < c_mid ? b1[j] : 0.f;
  if (tid < 32) b2s[tid] = tid < c_dec ? b2[tid] : 0.f;

  const bool xvec = c_in % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long tiles = ((long)n + SFT_ROWS - 1) / SFT_ROWS;
  auto stage = [&](long tile, int buf) {
    const long row0 = tile * SFT_ROWS;
    const int nrows = (int)min((long)SFT_ROWS, (long)n - row0);
    copy_rows<SFT_ROWS, SFT_XS>(xb + buf * SFT_ROWS * SFT_XS, x + row0 * c_in,
                                nrows, c_in, xvec);
    cp_async_commit();
  };

  const int rw = warp * 16;                     // this warp's rows
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  int buf = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    // This tile's rows have landed, and every warp is done with the other
    // buffer (the previous tile's x and d rows) and the weights.
    __syncthreads();
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    float* xt = xb + (buf * SFT_ROWS + rw) * SFT_XS;

    FragA ax[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = k * 8 + q;
      const float* X = xt + g * SFT_XS + c;
      const bool lo = c < c_in, hi = c + 4 < c_in;
      split_a(ax[k], lo ? X[0] : 0.f, lo ? X[8 * SFT_XS] : 0.f,
              hi ? X[4] : 0.f, hi ? X[8 * SFT_XS + 4] : 0.f);
    }
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

#pragma unroll
    for (int ch = 0; ch < 256 / SFT_CH; ++ch) {
      const int j0 = ch * SFT_CH;
      if (j0 >= c_mid) break;                   // uniform over the block
      float dc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        dc[t][0] = dc[t][1] = dc[t][2] = dc[t][3] = 0.f;
#pragma unroll
      for (int p = 0; p < SFT_CH / 16; ++p) {
        const int jn = j0 + p * 16;
        float z[2][4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          FragB bw[2];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float* Wz = w1s + (k * 8 + q) * SFT_WS + jn + t * 8 + g;
            split_b(bw[t], Wz[0], Wz[4 * SFT_WS]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int t = 0; t < 2; ++t) mma_term(z[t], ax[k], bw[t], term);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jl = jn + t * 8 + 2 * q;    // middle channel of C's 2q
          const float bb0 = b1s[jl], bb1 = b1s[jl + 1];
          // d += h W2 over these 8 middle channels: C columns 2q, 2q+1 are
          // A columns q, q+4, and B rows q, q+4 are W2[j0+jl], [+1].
          FragA ah;
          split_a(ah, fmaxf(z[t][0] + bb0, 0.f), fmaxf(z[t][2] + bb0, 0.f),
                  fmaxf(z[t][1] + bb1, 0.f), fmaxf(z[t][3] + bb1, 0.f));
          FragB bd[4];
#pragma unroll
          for (int ct = 0; ct < 4; ++ct) {
            const float2 w = *reinterpret_cast<const float2*>(
                w2s + (ct * 8 + g) * SFT_WS + jl);
            split_b(bd[ct], w.x, w.y);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int ct = 0; ct < 4; ++ct) mma_term(dc[ct], ah, bd[ct], term);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] += dc[t][i];
    }

    // d = acc + b2, staged in this warp's rows of the x buffer, then its
    // c_dec real columns stored: rows r0 .. r0 + 15 are contiguous in d.
    __syncwarp();                               // every lane's x read
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) {
      const int c = ct * 8 + 2 * q;
      const float bb0 = b2s[c], bb1 = b2s[c + 1];
      *reinterpret_cast<float2*>(xt + g * SFT_XS + c) =
          make_float2(acc[ct][0] + bb0, acc[ct][1] + bb1);
      *reinterpret_cast<float2*>(xt + (g + 8) * SFT_XS + c) =
          make_float2(acc[ct][2] + bb0, acc[ct][3] + bb1);
    }
    __syncwarp();
    const long r0 = tile * SFT_ROWS + rw;
    const int nr = (int)max(0L, min(16L, (long)n - r0));
    float* dst = d + r0 * c_dec;
    for (int e = lane; e < nr * c_dec; e += 32) {
      const int r = e / c_dec, c = e % c_dec;
      dst[e] = xt[r * SFT_XS + c];
    }
  }
}

cudaError_t launch_seg_fwd_tf32(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* d,
                                int n, int c_in, int c_mid, int c_dec,
                                cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * 32 * SFT_WS + 256 + 32 +
                       2 * SFT_ROWS * SFT_XS);
  auto kern = seg_fwd_tf32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      SFT_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + SFT_ROWS - 1) / SFT_ROWS;
  const long grid = std::min(tiles, (long)std::max(per_sm, 1) * sm_count());
  kern<<<(unsigned)grid, SFT_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(d), n, c_in, c_mid,
      c_dec);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// seg_fwd, float32, on the tensor cores as 3xTF32 beyond the flagship's     //
// widths, up to c_in, c_dec <= 64 and c_mid <= 512 (the 0.9411 model's     //
// 64/512/51, the 48-filter model's 48/384/38): seg_fwd_tf32_wide_kernel.  //
// ------------------------------------------------------------------------ //
//
// - Why chunks.  seg_fwd_tf32_kernel stages W1 and W2 whole; at 64/512
//   the two planes take 266,240 B padded, beyond the 232,448 B a block may
//   hold.  So C_mid goes in chunks of SFW_JC = 128 middle channels: a
//   persistent block walks tiles of SFW_ROWS = 128 rows and, for each, the
//   chunks in order; each chunk's W1 columns and W2 rows arrive by
//   cp.async in one of two buffers while the other chunk multiplies, so
//   the weights are read again from L2 for every tile (262,144 B a tile at
//   64/512: 1.14 GB a launch at N = 557,568).  One barrier a chunk guards
//   both weight buffers and, at a tile's last chunk, the other x buffer,
//   into which the next tile's rows are staged with the next weights.
// - Tiles: warp w of 8 owns rows 16 w .. 16 w + 15; x tiles [row][68]
//   (copy_rows: 16-byte copies where c_in % 4 == 0 and x is 16-byte
//   aligned, else 4; zeros past n).
// - Expand: x's A fragments of the KS k-steps (zero from c_in on) are split
//   once a tile and held in registers.  Per group of SFW_GROUP 8-column
//   n-tiles of the chunk, z = x W1 as three products (hi hi, lo hi, hi lo;
//   lo lo dropped), B words from the chunk's [c][j] plane of W1 (row stride
//   136, 8 mod 32: conflict-free), split at each load.
// - Decay, chained in registers as in seg_fwd_tf32_kernel: C columns 2q,
//   2q + 1 of h = relu(z + b1) are A columns q, q + 4, and B rows q, q + 4
//   are W2 rows j + 2q, j + 2q + 1, read from the chunk's [j][c] plane
//   (W2's rows as they lie in memory; row stride 68, 4 mod 32:
//   conflict-free, as are the x fragments' loads).  d (C_dec padded to
//   8 NCT) += h W2.
// - Sums: float32, no rounding point; the tensor cores sum with
//   truncation, so each chunk's decay products go to fresh accumulators,
//   added in float32 to the running d sums (b1 before the relu, b2 at the
//   end).  Deterministic: a fixed order.
// - Epilogue as in seg_fwd_tf32_kernel: + b2, staged in the warp's own
//   rows of the x tile (read once, at the tile's first chunk), then the
//   contiguous run of its rows' c_dec real columns stored; nothing past n.
// - Shared memory: 2 x 69,632 (weight chunks) + 2 x 34,816 (x tiles) +
//   2,304 (b1, b2): 211,200 B, one block an SM.  <KS, NCT> = <6, 5> for
//   c_in <= 48 and c_dec <= 40, else <8, 7> up to c_dec 56, else <8, 8>
//   (191, 212, 218 registers).  Measured against C_mid's chunks over the
//   grid, each block staging its chunk once and writing float32 parts of
//   d that dx_sum_kernel<float> sums (tools/seg_fwd_variants.py --section
//   wide, grid_split): 1.41 against 1.60 ms at 64/512/51; the restaging
//   costs 0.33 ms of the 1.41.
//
// What bounds it on an H100 at the 64-filter model's train step (N =
// 557,568, 64/512/51): 2 N c_mid (c_in + c_dec) = 65.66 GFLOP, three TF32
// products each, 0.3982 ms at the 494.7 TFLOP/s TF32 peak (0.980 ms at the
// CUDA cores' 67 TFLOP/s), against 256 MB of x and d (0.077 ms):
// operations.  It issues C_dec padded to 56 (1.04x the products), on
// mma.sync, which issues near half the TF32 rate.

constexpr int SFW_WARPS = 8;                   // 16 rows each
constexpr int SFW_ROWS = 16 * SFW_WARPS;       // rows per tile
constexpr int SFW_JC = 128;                    // middle channels per chunk
constexpr int SFW_GROUP = 4;                   // n-tiles of z at a time
constexpr int SFW_CH = 64;                     // c_in, c_dec it takes
constexpr int SFW_MID = 512;                   // c_mid it takes
constexpr int SFW_XS = SFW_CH + 4;             // x tile, W2 [j][c] stride
constexpr int SFW_WS = SFW_JC + 8;             // W1 [c][j] stride
constexpr int SFW_WBUF = SFW_CH * SFW_WS + SFW_JC * SFW_XS;  // a chunk

size_t seg_fwd_tf32_wide_smem() {
  return sizeof(float) * ((size_t)2 * SFW_WBUF + 2 * SFW_ROWS * SFW_XS +
                          SFW_MID + SFW_CH);
}

template <int KS, int NCT>
__global__ void __launch_bounds__(SFW_WARPS * 32, 1)
seg_fwd_tf32_wide_kernel(const float* __restrict__ x,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ d,
                         int n, int c_in, int c_mid, int c_dec) {
  constexpr int XS = SFW_XS, WS = SFW_WS, JC = SFW_JC, ROWS = SFW_ROWS;
  constexpr int NG = SFW_GROUP;
  static_assert(JC % (8 * NG) == 0, "whole groups a chunk");
  static_assert(8 * KS <= SFW_CH && 8 * NCT <= SFW_CH, "widths");
  extern __shared__ __align__(16) float smem[];
  float* wb = smem;                             // [2][WBUF]  weight chunks
  float* xb = wb + 2 * SFW_WBUF;                // [2][ROWS][XS]  x tiles
  float* b1s = xb + 2 * ROWS * XS;              // [MID]
  float* b2s = b1s + SFW_MID;                   // [CH]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;

  for (int j = tid; j < SFW_MID; j += blockDim.x)
    b1s[j] = j < c_mid ? b1[j] : 0.f;
  if (tid < SFW_CH) b2s[tid] = tid < c_dec ? b2[tid] : 0.f;
  // The last d n-tile reads W2's columns from c_dec on, which copy_rows
  // never writes: zero them once in both buffers.
  for (int e = tid; e < 2 * JC * XS; e += blockDim.x)
    if (e % XS >= c_dec)
      wb[e / (JC * XS) * SFW_WBUF + SFW_CH * WS + e % (JC * XS)] = 0.f;

  const bool xvec = c_in % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w1vec = c_mid % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  const bool w2vec = c_dec % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  const int nch = (c_mid + JC - 1) / JC;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  // Chunk ch of W1 as the [c][j] plane (zeros from c_in and c_mid on) and
  // of W2 as the [j][c] plane (zeros from c_mid on), into buffer `buf`.
  auto stage_w = [&](int ch, int buf) {
    const int j0 = ch * JC;
    float* p = wb + buf * SFW_WBUF;
    if (w1vec) {
      for (int e = tid; e < SFW_CH * JC / 4; e += blockDim.x) {
        const int c = e / (JC / 4), j = 4 * (e % (JC / 4));
        const bool in = c < c_in && j0 + j < c_mid;
        probav::cp_async16_zfill(p + c * WS + j,
                                 in ? w1 + (long)c * c_mid + j0 + j : w1, in);
      }
    } else {
      for (int e = tid; e < SFW_CH * JC; e += blockDim.x) {
        const int c = e / JC, j = e % JC;
        const bool in = c < c_in && j0 + j < c_mid;
        probav::cp_async4_zfill(p + c * WS + j,
                                in ? w1 + (long)c * c_mid + j0 + j : w1, in);
      }
    }
    copy_rows<JC, XS>(p + SFW_CH * WS, w2 + (long)j0 * c_dec,
                      min(JC, c_mid - j0), c_dec, w2vec);
  };
  auto stage_x = [&](long tile, int buf) {
    const long row0 = tile * ROWS;
    copy_rows<ROWS, XS>(xb + buf * ROWS * XS, x + row0 * c_in,
                        (int)min((long)ROWS, (long)n - row0), c_in, xvec);
  };

  // Item s of this block: tile blockIdx.x + (s / nch) gridDim.x, chunk
  // s % nch.
  const long items = blockIdx.x < tiles
                         ? ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nch
                         : 0;
  if (items > 0) {
    stage_x(blockIdx.x, 0);
    stage_w(0, 0);
  }
  cp_async_commit();
  const int rw = warp * 16;                     // this warp's rows
  FragA ax[KS];
  float acc[NCT][4];
  for (long s = 0; s < items; ++s) {
    const long tile = blockIdx.x + s / nch * gridDim.x;
    const int ch = (int)(s % nch), wbuf = (int)(s % 2);
    const int xbuf = (int)(s / nch % 2);
    cp_async_wait_all();
    // This item's weights (and at a tile's first chunk its rows) have
    // landed; every warp is done with the other weight buffer and, at a
    // tile's last chunk, with the other x buffer (the previous tile's).
    __syncthreads();
    if (s + 1 < items) {
      stage_w(ch + 1 < nch ? ch + 1 : 0, wbuf ^ 1);
      if (ch + 1 == nch) stage_x(tile + gridDim.x, xbuf ^ 1);
    }
    cp_async_commit();
    float* xt = xb + (xbuf * ROWS + rw) * XS;

    if (ch == 0) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const int c = k * 8 + q;
        const float* X = xt + g * XS + c;
        const bool lo = c < c_in, hi = c + 4 < c_in;
        split_a(ax[k], lo ? X[0] : 0.f, lo ? X[8 * XS] : 0.f,
                hi ? X[4] : 0.f, hi ? X[8 * XS + 4] : 0.f);
      }
#pragma unroll
      for (int t = 0; t < NCT; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    }

    const float* w1c = wb + wbuf * SFW_WBUF;    // [CH][WS]  W1[c][j0 + j]
    const float* w2c = w1c + SFW_CH * WS;       // [JC][XS]  W2[j0 + j][c]
    const float* b1c = b1s + ch * JC;
    float dc[NCT][4];
#pragma unroll
    for (int t = 0; t < NCT; ++t)
      dc[t][0] = dc[t][1] = dc[t][2] = dc[t][3] = 0.f;
#pragma unroll
    for (int p = 0; p < JC / (8 * NG); ++p) {
      const int jn = p * 8 * NG;
      float z[NG][4] = {};
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        FragB bw[NG];
#pragma unroll
        for (int t = 0; t < NG; ++t) {
          const float* W = w1c + (k * 8 + q) * WS + jn + t * 8 + g;
          split_b(bw[t], W[0], W[4 * WS]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int t = 0; t < NG; ++t) mma_term(z[t], ax[k], bw[t], term);
      }
#pragma unroll
      for (int t = 0; t < NG; ++t) {
        const int jl = jn + t * 8 + 2 * q;      // chunk's j of C column 2q
        const float bb0 = b1c[jl], bb1 = b1c[jl + 1];
        FragA ah;
        split_a(ah, fmaxf(z[t][0] + bb0, 0.f), fmaxf(z[t][2] + bb0, 0.f),
                fmaxf(z[t][1] + bb1, 0.f), fmaxf(z[t][3] + bb1, 0.f));
        FragB bd[NCT];
#pragma unroll
        for (int ct = 0; ct < NCT; ++ct) {
          const float* W = w2c + jl * XS + ct * 8 + g;
          split_b(bd[ct], W[0], W[XS]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int ct = 0; ct < NCT; ++ct) mma_term(dc[ct], ah, bd[ct], term);
      }
    }
#pragma unroll
    for (int t = 0; t < NCT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] += dc[t][i];

    if (ch == nch - 1) {
      // d = acc + b2, staged in this warp's rows of its x tile, then its
      // c_dec real columns stored: rows r0 .. r0 + 15 are contiguous in d.
      __syncwarp();                             // every lane's x read
#pragma unroll
      for (int ct = 0; ct < NCT; ++ct) {
        const int c = ct * 8 + 2 * q;
        const float bb0 = b2s[c], bb1 = b2s[c + 1];
        *reinterpret_cast<float2*>(xt + g * XS + c) =
            make_float2(acc[ct][0] + bb0, acc[ct][1] + bb1);
        *reinterpret_cast<float2*>(xt + (g + 8) * XS + c) =
            make_float2(acc[ct][2] + bb0, acc[ct][3] + bb1);
      }
      __syncwarp();
      const long r0 = tile * ROWS + rw;
      const int nr = (int)max(0L, min(16L, (long)n - r0));
      float* dst = d + r0 * c_dec;
      for (int e = lane; e < nr * c_dec; e += 32) {
        const int r = e / c_dec, c = e % c_dec;
        dst[e] = xt[r * XS + c];
      }
    }
  }
}

template <int KS, int NCT>
cudaError_t launch_seg_fwd_tf32_wide_as(const void* x, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, void* d, int n,
                                        int c_in, int c_mid, int c_dec,
                                        cudaStream_t s) {
  const size_t smem = seg_fwd_tf32_wide_smem();
  auto kern = seg_fwd_tf32_wide_kernel<KS, NCT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      SFW_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + SFW_ROWS - 1) / SFW_ROWS;
  const long grid = std::min(tiles, (long)std::max(per_sm, 1) * sm_count());
  kern<<<(unsigned)grid, SFW_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(d), n, c_in, c_mid,
      c_dec);
  return cudaGetLastError();
}

cudaError_t launch_seg_fwd_tf32_wide(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* d, int n,
                                     int c_in, int c_mid, int c_dec,
                                     cudaStream_t s) {
  if (c_in > SFW_CH || c_dec > SFW_CH || c_mid > SFW_MID)
    return cudaErrorInvalidValue;
  if (c_in <= 48 && c_dec <= 40)
    return launch_seg_fwd_tf32_wide_as<6, 5>(x, w1, b1, w2, b2, d, n, c_in,
                                             c_mid, c_dec, s);
  if (c_dec <= 56)
    return launch_seg_fwd_tf32_wide_as<8, 7>(x, w1, b1, w2, b2, d, n, c_in,
                                             c_mid, c_dec, s);
  return launch_seg_fwd_tf32_wide_as<8, 8>(x, w1, b1, w2, b2, d, n, c_in,
                                           c_mid, c_dec, s);
}

// Which kernel probav_seg_fwd runs, from the dtype and widths alone: where
// the tensor-core tiles cover the widths (c_in, c_dec <= 32, c_mid <= 256)
// seg_fwd_bf16_kernel at bf16 and seg_fwd_tf32_kernel at float32; beyond,
// up to c_in, c_dec <= 64 and c_mid <= 512, seg_fwd_bf16_wide_kernel at
// bf16 and seg_fwd_tf32_wide_kernel at float32; wider, seg_fwd_mma_kernel
// at bf16 and seg_fwd_kernel (CUDA cores) at float32.
enum SegFwdRoute { SEG_FWD_CUDA_CORES = 0, SEG_FWD_BF16_MMA = 1,
                   SEG_FWD_TF32_MMA = 2, SEG_FWD_BF16_LDSM = 3,
                   SEG_FWD_TF32_WIDE = 4, SEG_FWD_BF16_WIDE = 5 };

SegFwdRoute seg_fwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  const bool tiles = c_in <= 32 && c_dec <= 32 && c_mid <= 256;
  const bool wide = c_in <= SFW_CH && c_dec <= SFW_CH && c_mid <= SFW_MID;
  if (dtype == 1)
    return tiles ? SEG_FWD_BF16_LDSM
                 : wide ? SEG_FWD_BF16_WIDE : SEG_FWD_BF16_MMA;
  return tiles ? SEG_FWD_TF32_MMA
               : wide ? SEG_FWD_TF32_WIDE : SEG_FWD_CUDA_CORES;
}

// ------------------------------------------------------------------------ //
// bf16 on the tensor cores (mma.sync.m16n8k16, fragment layouts in          //
// common.cuh).  The C tiles of two adjacent 8-column blocks are exactly the //
// A fragment of the 16-wide k-step they form, which lets seg_fwd feed its   //
// expand output into the decay product without leaving registers.          //
// ------------------------------------------------------------------------ //

constexpr int MMA_WARPS = 4;     // warps per block of seg_fwd_mma_kernel

// seg_fwd, bf16.  Each warp takes 16-row tiles; the expand product
// z = x W1 (K = 16*KS1) is made 8 middle channels at a time, + b1, relu,
// rounded to bf16 in registers and immediately used as the A operand of the
// decay product d += h W2 (N = 8*NT2).  W1^T [mch][16*KS1] and
// W2^T [8*NT2][mch] are staged in shared memory for mch middle channels at
// a time, rows padded by 8 elements so that the fragment loads hit
// distinct banks: all of c_mid once per block where it fits (the
// flagship's 32/256/25: 38,400 B), else in chunks restaged for each group
// of MMA_WARPS tiles (at 128/1024/102, five chunks of 208), the decay
// accumulators held in registers across the chunks.
template <int KS1, int NT2>
__global__ void __launch_bounds__(MMA_WARPS * 32)
seg_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ d,
                   int n, int c_in, int c_mid, int c_dec, int c_mid16,
                   int mch) {
  constexpr int CIP = 16 * KS1 + 8;            // W1^T row stride
  const int CMP = mch + 8;                     // W2^T row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w2s = w1s + mch * CIP;
  float* b1s = reinterpret_cast<float*>(w2s + 8 * NT2 * CMP);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // Middle channels j0 .. j0 + mch - 1, staged in the global arrays' order
  // (coalesced reads); pad columns of the smem rows are never read.
  auto stage = [&](int j0) {
    for (int e = threadIdx.x; e < 16 * KS1 * mch; e += blockDim.x) {
      const int k = e / mch, j = e % mch, jm = j0 + j;
      w1s[j * CIP + k] =
          (jm < c_mid && k < c_in) ? w1[(long)k * c_mid + jm] : zero;
    }
    for (int e = threadIdx.x; e < mch * 8 * NT2; e += blockDim.x) {
      const int j = e / (8 * NT2), c = e % (8 * NT2), jm = j0 + j;
      w2s[c * CMP + j] =
          (c < c_dec && jm < c_mid) ? w2[(long)jm * c_dec + c] : zero;
    }
    for (int j = threadIdx.x; j < mch; j += blockDim.x)
      b1s[j] = j0 + j < c_mid ? b1[j0 + j] : 0.f;
  };
  const bool whole = mch >= c_mid16;
  if (whole) {
    stage(0);
    __syncthreads();
  }

  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int warp = threadIdx.x / 32;
  const long tiles = ((long)n + 15) / 16;
  const long groups = (tiles + MMA_WARPS - 1) / MMA_WARPS;
  for (long grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const long tile = grp * MMA_WARPS + warp;
    const bool live = tile < tiles;
    const long r0 = tile * 16 + g, r1 = r0 + 8;
    uint32_t a1[KS1][4];
#pragma unroll
    for (int kk = 0; kk < KS1; ++kk) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long r = (i & 1) ? r1 : r0;          // a0 a1 a2 a3 =
        const int k = kk * 16 + 2 * q + (i & 4 ? 8 : 0) + (i & 2 ? 1 : 0);
        v[i] = (r < n && k < c_in) ? __bfloat162float(x[r * c_in + k]) : 0.f;
      }                                            // (r0|r1) x (k|k+8)
      a1[kk][0] = pack_bf16(v[0], v[2]);
      a1[kk][1] = pack_bf16(v[1], v[3]);
      a1[kk][2] = pack_bf16(v[4], v[6]);
      a1[kk][3] = pack_bf16(v[5], v[7]);
    }
    float acc[NT2][4];
#pragma unroll
    for (int t = 0; t < NT2; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

    for (int j0 = 0; j0 < c_mid16; j0 += mch) {
      if (!whole) {   // every warp of the block, live or not
        __syncthreads();
        stage(j0);
        __syncthreads();
      }
      if (!live) continue;
      const int steps = min(mch, c_mid16 - j0) / 16;
      for (int s = 0; s < steps; ++s) {
        uint32_t a2[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n0 = s * 16 + half * 8;
          float z[4] = {0.f, 0.f, 0.f, 0.f};
          const __nv_bfloat16* wrow = w1s + (n0 + g) * CIP + 2 * q;
#pragma unroll
          for (int kk = 0; kk < KS1; ++kk)
            mma_bf16(z, a1[kk], lds32(wrow + kk * 16),
                     lds32(wrow + kk * 16 + 8));
          // + b1, relu, round to bf16 before the decay product
          // (pallas_tstack.py:237-238).
          const float bb0 = b1s[n0 + 2 * q], bb1 = b1s[n0 + 2 * q + 1];
          a2[2 * half + 0] = pack_bf16(fmaxf(z[0] + bb0, 0.f),
                                       fmaxf(z[1] + bb1, 0.f));
          a2[2 * half + 1] = pack_bf16(fmaxf(z[2] + bb0, 0.f),
                                       fmaxf(z[3] + bb1, 0.f));
        }
#pragma unroll
        for (int t = 0; t < NT2; ++t) {
          const __nv_bfloat16* wrow = w2s + (t * 8 + g) * CMP + s * 16 + 2 * q;
          mma_bf16(acc[t], a2, lds32(wrow), lds32(wrow + 8));
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int t = 0; t < NT2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long r = i < 2 ? r0 : r1;
        const int c = t * 8 + 2 * q + (i & 1);
        if (r < n && c < c_dec)
          d[r * c_dec + c] = __float2bfloat16_rn(acc[t][i] + b2[c]);
      }
    }
  }
}

// Shared-memory bytes of seg_fwd_mma_kernel<KS1, NT2> staging mch middle
// channels at a time.
template <int KS1, int NT2>
size_t seg_mma_smem(int mch) {
  return sizeof(__nv_bfloat16) * ((size_t)mch * (16 * KS1 + 8) +
                                  (size_t)8 * NT2 * (mch + 8)) +
         sizeof(float) * mch;
}

template <int KS1, int NT2>
cudaError_t launch_seg_mma(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* d, int n,
                           int c_in, int c_mid, int c_dec, cudaStream_t s) {
  const int c_mid16 = (c_mid + 15) / 16 * 16;
  // All of c_mid where it fits, else the largest chunk with which two
  // blocks share an SM (one stages while the other computes).
  const size_t optin = (size_t)probav::optin_smem();
  int mch = c_mid16;
  if (seg_mma_smem<KS1, NT2>(mch) > optin) {
    while (mch > 16 && seg_mma_smem<KS1, NT2>(mch) > optin / 2) mch -= 16;
  }
  const size_t smem = seg_mma_smem<KS1, NT2>(mch);
  auto kern = seg_fwd_mma_kernel<KS1, NT2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + 15) / 16;
  const long want = (tiles + MMA_WARPS - 1) / MMA_WARPS;
  const long cap = 8L * sm_count();
  const int grid = (int)(want < cap ? want : cap);
  kern<<<grid, MMA_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(d), n, c_in, c_mid, c_dec, c_mid16, mch);
  return cudaGetLastError();
}

// K = c_in and N = c_dec in 32-channel buckets: KS1 = 2 .. 8 k-steps of 16,
// NT2 = 4 .. 16 column tiles of 8.
cudaError_t dispatch_seg_mma(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* d, int n,
                             int c_in, int c_mid, int c_dec, cudaStream_t s) {
  return probav::by_bucket(c_in, [&](auto ci) {
    return probav::by_bucket(c_dec, [&](auto cd) {
      return launch_seg_mma<decltype(ci)::value / 16, decltype(cd)::value / 8>(
          x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
    });
  });
}

// ------------------------------------------------------------------------ //
// seg_fwd, bf16, designed for Hopper: seg_fwd_bf16_kernel, for c_in, c_dec //
// <= 32 and c_mid <= 256 (seg_fwd_route; the flagship's 32/256/25).  It    //
// replaces the TPU kernel pallas_tstack.py:244 seg_fwd at bf16 there and   //
// computes what seg_fwd_mma_kernel computes, with the same rounding        //
// points: z = x W1 + b1 summed in float32, h = relu(z) rounded to bf16,    //
// d = bf16(h W2 + b2) summed in float32.                                   //
// ------------------------------------------------------------------------ //
//
// - Tiles: a persistent grid (blocks an SM from the occupancy API times the
//   SMs, at most the tile count) walks tiles of SFB_ROWS = 256 rows; warp w
//   of 8 owns rows 32 w .. 32 w + 31 of each, SFB_MT = 2 row tiles of 16.
//   x tiles are double-buffered as [row][40] bf16 (80-byte rows: the 8 rows
//   of an ldmatrix fall in distinct banks); the next tile's rows arrive by
//   16-byte cp.async (where c_in % 8 == 0 and x is 16-byte aligned, else
//   plain copies; zeros past n) while this one computes, and one barrier a
//   tile guards both buffers.  Columns c_in..31 of both buffers are zeroed
//   once and never written: the fragments read them against zero rows of
//   W1, and 0 x NaN would be NaN.
// - Weights staged once per block, zero-padded to 256 x 32: W1 as [j][k]
//   rows of 40, W2 as [c][j] rows of 264 (8 words mod 32: conflict-free
//   rows), b1 in float32; b2 in registers.  Plain ldmatrix.x4 of W1 [j][k]
//   gives the expand's B fragments (16 middle channels x 32 inputs in two),
//   of W2 [c][j] the decay's (32 outputs x 16 middle channels in two).
// - A step is 16 middle channels: its 4 ldmatrix.x4 of weights feed 8 mma
//   for each of the warp's SFB_MT row tiles, whose x A fragments are loaded
//   once a tile.  z = x W1 starts from b1 in the mma's sums; relu and the
//   rounding to bf16 are one cvt.rn.relu.bf16x2.f32 a pair, and the two
//   8-column C tiles of z are the A fragment of the decay's 16-wide k-step
//   (C columns 2q, 2q+1 are A columns 2q, 2q+1), so h never leaves
//   registers.  The 16 steps are unrolled, each step's weight fragments
//   loaded during the step before; steps past c_mid are not run (uniform
//   over the block), and padded middle channels give z = h = 0.
// - Epilogue: + b2, rounded to bf16, staged in the warp's own buffer as the
//   contiguous span of its rows' c_dec columns at d's 16-byte skew, then
//   stored by the warp as 16-byte pieces (element by element at the span's
//   two ends); nothing past n.
//
// - Shared memory: 20,480 (W1) + 16,896 (W2) + 2 x 20,480 (x tiles) +
//   8 x 2,064 (spans) + 1,024 (b1) = 95,872 B; two blocks an SM, at most
//   128 registers each.  Measured against one block of 8, 12 or 16 warps,
//   two of 6, three of 4, 1 or 4 row tiles a warp and the steps rolled
//   (tools/seg_fwd_variants.py, PERF.md): the fastest.
//
// What bounds it on an H100 at the flagship (N = 557,568): 35.7 MB of x
// read and 27.9 MB of d written, 0.019 ms at 3.35 TB/s, against 16.3 GFLOP
// (0.0165 ms at the 989 TFLOP/s bf16 peak; mma issues C_dec padded to 32):
// bytes.  mma.sync issues near half that peak, so the products alone take
// about as long as the bytes; they do not overlap the weight fragments'
// shared-memory reads, the relu and rounding and the epilogue well
// (without the mma it takes about 55% of its time).

constexpr int SFB_WARPS = 8;                       // warps per block
constexpr int SFB_MT = 2;                          // 16-row tiles per warp
constexpr int SFB_MINB = 2;                        // blocks per SM
constexpr int SFB_ROWS = 16 * SFB_MT * SFB_WARPS;  // rows per tile
constexpr int SFB_XS = 40;                         // x tile, W1 [j][k] stride
constexpr int SFB_WS = 256 + 8;                    // W2 [c][j] row stride
constexpr int SFB_DS = 16 * SFB_MT * 32 + 8;       // a warp's d span buffer

constexpr size_t seg_fwd_bf16_smem() {
  return sizeof(__nv_bfloat16) *
             ((size_t)256 * SFB_XS + 32 * SFB_WS + 2 * SFB_ROWS * SFB_XS +
              SFB_WARPS * SFB_DS) +
         sizeof(float) * 256;
}

__global__ void __launch_bounds__(SFB_WARPS * 32, SFB_MINB)
seg_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    const float* __restrict__ b2,
                    __nv_bfloat16* __restrict__ d, int n, int c_in,
                    int c_mid, int c_dec) {
  using E = __nv_bfloat16;
  constexpr int NTH = SFB_WARPS * 32, MT = SFB_MT, ROWS = SFB_ROWS;
  constexpr int XS = SFB_XS, WS = SFB_WS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* w1s = reinterpret_cast<E*>(smem_raw);   // [256][XS]  w1[k][j] at [j][k]
  E* w2s = w1s + 256 * XS;                   // [32][WS]   w2[j][c] at [c][j]
  E* xb = w2s + 32 * WS;                     // [2][ROWS][XS]  x tiles
  E* spans = xb + 2 * ROWS * XS;             // [WARPS][DS]  d spans
  float* b1s = reinterpret_cast<float*>(spans + SFB_WARPS * SFB_DS);  // [256]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const E zero = __float2bfloat16_rn(0.f);

  const bool xvec = c_in % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  // Rows of tile t into buffer `buf`, zeros past n: 16-byte cp.async where
  // `xvec`, else plain copies.
  auto stage = [&](long t, int buf) {
    const E* src = x + t * ROWS * c_in;
    const int nr = (int)min((long)ROWS, (long)n - t * ROWS);
    E* dst = xb + buf * ROWS * XS;
    if (xvec) {
      const int c8 = c_in / 8;
      for (int e = tid; e < ROWS * c8; e += NTH) {
        const int r = e / c8, c = 8 * (e % c8);
        const bool in = r < nr;
        probav::cp_async16_zfill(dst + r * XS + c,
                                 in ? src + r * c_in + c : src, in);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < ROWS * c_in; e += NTH) {
        const int r = e / c_in, c = e % c_in;
        dst[r * XS + c] = r < nr ? src[r * c_in + c] : zero;
      }
    }
  };

  // The first tile's rows are on their way while the weights are staged,
  // in the global arrays' order, 8 loads of each in flight; x's pad columns
  // in both buffers (the copies write columns 0 .. c_in - 1 only, so no
  // barrier orders them); b2 at this lane's C columns.
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  for (int e0 = tid; e0 < 256 * 32; e0 += 8 * NTH) {
    E v1[8], v2[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NTH;
      const int k = e / 256, j = e % 256, j2 = e / 32, c = e % 32;
      v1[u] = (k < c_in && j < c_mid) ? w1[k * c_mid + j] : zero;
      v2[u] = (j2 < c_mid && c < c_dec) ? w2[j2 * c_dec + c] : zero;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * NTH;
      if (e < 256 * 32) {
        w1s[(e % 256) * XS + e / 256] = v1[u];
        w2s[(e % 32) * WS + e / 32] = v2[u];
      }
    }
  }
  for (int j = tid; j < 256; j += NTH) b1s[j] = j < c_mid ? b1[j] : 0.f;
  if (c_in < 32) {
    const int pad = 32 - c_in;
    for (int e = tid; e < 2 * ROWS * pad; e += NTH)
      xb[(e / pad) * XS + c_in + e % pad] = zero;
  }
  float bo[4][2];
#pragma unroll
  for (int ct = 0; ct < 4; ++ct)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = 8 * ct + 2 * q + k;
      bo[ct][k] = c < c_dec ? b2[c] : 0.f;
    }

  // This lane's ldmatrix rows: x's A tiles (rows lane % 16, 16 bytes of
  // columns from lane / 16 on), W1's B tiles (middle channel lane % 8,
  // inputs from 8 (lane / 8) on), W2's (output 8 (lane / 16) + lane % 8,
  // middle channels from 8 ((lane / 8) % 2) on).
  const int xoff = (lane % 8 + 8 * ((lane / 8) % 2)) * XS + 8 * (lane / 16);
  const int w1off = (lane % 8) * XS + 8 * (lane / 8);
  const int w2off = (8 * (lane / 16) + lane % 8) * WS + 8 * ((lane / 8) % 2);
  const int steps = (c_mid + 15) / 16;
  const int rw = warp * 16 * MT;             // this warp's rows of a tile
  E* span = spans + warp * SFB_DS;           // and its d span buffer

  int buf = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    // This tile's rows have landed, every warp is done with the other
    // buffer, and (the first time) the weights are staged.
    __syncthreads();
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    const E* xt = xb + (buf * ROWS + rw) * XS;

    uint32_t ax[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(ax[m][ks], xt + m * 16 * XS + 16 * ks + xoff);
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
        acc[m][ct][0] = acc[m][ct][1] = acc[m][ct][2] = acc[m][ct][3] = 0.f;

    // Step s's fragments: fw[t] = W1's B of middle channels 16 s + 8 t ..
    // (registers: inputs 0-7, 8-15, 16-23, 24-31), fd[p] = W2's B of
    // outputs 16 p .. 16 p + 15 (registers: outputs 16 p .. + 7 at middle
    // channels 16 s .. + 7 and + 8 .. + 15, then outputs 16 p + 8 ..).
    uint32_t fw[2][4], fd[2][4];
    auto load = [&](int s) {
      ldsm_x4(fw[0], w1s + 16 * s * XS + w1off);
      ldsm_x4(fw[1], w1s + (16 * s + 8) * XS + w1off);
      ldsm_x4(fd[0], w2s + 16 * s + w2off);
      ldsm_x4(fd[1], w2s + 16 * WS + 16 * s + w2off);
    };
    load(0);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if (s >= steps) break;                   // uniform over the block
      uint32_t cw[2][4], cd[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) cw[t][i] = fw[t][i], cd[t][i] = fd[t][i];
      if (s + 1 < 16) load(s + 1);             // rows past c_mid are zeros
      const float2 bb0 = *reinterpret_cast<const float2*>(b1s + 16 * s +
                                                           2 * q);
      const float2 bb1 = *reinterpret_cast<const float2*>(b1s + 16 * s + 8 +
                                                           2 * q);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float z[2][4] = {{bb0.x, bb0.y, bb0.x, bb0.y},
                         {bb1.x, bb1.y, bb1.x, bb1.y}};
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            mma_bf16(z[t], ax[m][ks], cw[t][2 * ks], cw[t][2 * ks + 1]);
        // relu, rounded to bf16 before the decay (pallas_tstack.py:237-238).
        const uint32_t ah[4] = {relu_bf16x2(z[0][0], z[0][1]),
                                relu_bf16x2(z[0][2], z[0][3]),
                                relu_bf16x2(z[1][0], z[1][1]),
                                relu_bf16x2(z[1][2], z[1][3])};
#pragma unroll
        for (int ct = 0; ct < 4; ++ct)
          mma_bf16(acc[m][ct], ah, cd[ct / 2][2 * (ct % 2)],
                   cd[ct / 2][2 * (ct % 2) + 1]);
      }
    }

    // d = acc + b2, rounded, staged as the span of this warp's rows (rows
    // r0 .. r0 + 16 MT - 1 are contiguous in d), then stored (the tile's
    // barrier ordered the previous span's stores before these writes).
    const long r0 = tile * ROWS + rw;
    const int nr = (int)max(0L, min((long)(16 * MT), (long)n - r0));
    E* dst = d + r0 * c_dec;
    const int skew = (int)((reinterpret_cast<uintptr_t>(dst) & 15) /
                           sizeof(E));
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + g + 8 * (i / 2), c = 8 * ct + 2 * q + i % 2;
          if (c < c_dec)
            span[skew + r * c_dec + c] =
                __float2bfloat16_rn(acc[m][ct][i] + bo[ct][i % 2]);
        }
    __syncwarp();
    store_span_warp(dst, span, skew, nr * c_dec, lane);
  }
}

cudaError_t launch_seg_fwd_bf16(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* d,
                                int n, int c_in, int c_mid, int c_dec,
                                cudaStream_t s) {
  constexpr size_t smem = seg_fwd_bf16_smem();
  auto kern = seg_fwd_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      SFB_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + SFB_ROWS - 1) / SFB_ROWS;
  const long grid = std::min(tiles, (long)std::max(per_sm, 1) * sm_count());
  kern<<<(unsigned)grid, SFB_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(d), n, c_in, c_mid, c_dec);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// seg_fwd, bf16, designed for Hopper past the flagship's widths:           //
// seg_fwd_bf16_wide_kernel, for c_in, c_dec <= 64 and c_mid <= 512 where   //
// seg_fwd_bf16_kernel's tiles end (seg_fwd_route; the 64-filter model's    //
// 64/512/51, and 48/384/38).  It replaces the TPU kernel                   //
// pallas_tstack.py:244 seg_fwd at bf16 there, with seg_fwd_bf16_kernel's   //
// rounding points: z = x W1 + b1 summed in float32, h = relu(z) rounded    //
// to bf16, d = bf16(h W2 + b2) summed in float32.                          //
// ------------------------------------------------------------------------ //
//
// seg_fwd_bf16_kernel scaled up; the bf16 weights fit shared memory at
// these widths, so unlike seg_fwd_tf32_wide_kernel nothing is restaged:
//
// - Tiles: a persistent grid (one block an SM, the occupancy API's count
//   times the SMs, at most the tile count) walks tiles of SFBW_ROWS = 256
//   rows; warp w of 8 owns rows 32 w .. 32 w + 31 of each, SFBW_MT = 2 row
//   tiles of 16.  x tiles are double-buffered as [row][72] bf16 (144-byte
//   rows, 16 mod 128: the 8 rows of an ldmatrix fall in distinct banks);
//   the next tile's rows arrive by 16-byte cp.async (where c_in % 8 == 0
//   and x is 16-byte aligned, else plain copies) while this one computes,
//   one barrier a tile guarding both buffers.  Every copy writes the 16 KS
//   columns the fragments read, zeros from c_in on and past n: a tile's
//   buffer also stages its d (below), so no column keeps zeros by itself.
// - Weights staged once a block into two zeroed [64][520] planes
//   (1,040-byte rows, 16 mod 128): W1 as it lies in memory, [k][j], by
//   16-byte cp.async (element copies where c_mid % 8 != 0 or w1 is not
//   16-byte aligned), and W2 transposed to [c][j] from 16-byte loads of
//   the flat array (element loads where it is not aligned); b1, b2 in
//   float32.  ldmatrix.x4.trans of W1 [k][j] gives the expand's B
//   fragments, plain ldmatrix.x4 of W2 [c][j] the decay's.  (W1
//   transposed to [j][k] as well, the flagship's layout, took 2-byte
//   stores with 32-way bank conflicts: the weights' staging then cost
//   ~0.025 of 0.216 ms on an H100, tools/seg_fwd_variants.py.)
// - A step is 16 middle channels: KS ldmatrix.x4 of W1 (16 middle
//   channels x 16 KS inputs) and NP = ceil(NT / 2) of W2 (16 NP outputs x
//   16 middle channels), each used for both row tiles, whose x A
//   fragments are loaded once a tile; 2 KS + NT mma a row tile.  z = x W1
//   starts from b1 in the mma's sums; relu and the rounding to bf16 are
//   one cvt.rn.relu.bf16x2.f32 a pair, and the two 8-column C tiles of z
//   are the decay's A fragment (C columns 2q, 2q+1 are A columns 2q,
//   2q+1), so h never leaves registers.  Steps go in pairs through two
//   fragment sets, each step's loaded during the step before; steps past
//   c_mid are not run (uniform over the block), and padded middle channels
//   give z = h = 0.
// - Epilogue: + b2, rounded to bf16, staged in the warp's own rows of the
//   x tile it has read (its A fragments are in registers) as the
//   contiguous span of its rows' c_dec columns at d's 16-byte skew, then
//   stored by the warp as 16-byte pieces (element by element at the
//   span's two ends); nothing past n.  The next barrier orders the span's
//   reads before the buffer's next copy.
//
// - Shared memory: 2 x 66,560 (W1, W2) + 2 x 36,864 (x tiles) + 2,304
//   (b1, b2) = 209,152 B, one block an SM; separate span buffers (32,896
//   B more) would not fit.  Instantiated as
//   <KS, NT> = <3, 5> (c_in <= 48, c_dec <= 40: 48/384/38), <4, 7> (c_dec
//   <= 56: 64/512/51), <4, 8>.
//
// What bounds it on an H100 at 64/512/51 (N = 557,568): 2 N c_mid (c_in +
// c_dec) = 65.66 GFLOP, 0.0664 ms at the 989 TFLOP/s bf16 peak, against
// 128 MB of x and d (0.038 ms): operations.  mma.sync issues near half that
// peak, and C_dec padded to 56 issues 1.04x the products.

constexpr int SFBW_WARPS = 8;                        // warps per block
constexpr int SFBW_MT = 2;                           // 16-row tiles per warp
constexpr int SFBW_MINB = 1;                         // blocks per SM
constexpr int SFBW_ROWS = 16 * SFBW_MT * SFBW_WARPS; // rows per tile
constexpr int SFBW_CH = 64;                          // c_in, c_dec it takes
constexpr int SFBW_MID = 512;                        // c_mid it takes
constexpr int SFBW_XS = SFBW_CH + 8;                 // x tile row stride
constexpr int SFBW_WS = SFBW_MID + 8;                // W1 [k][j], W2 [c][j]

constexpr size_t seg_fwd_bf16_wide_smem() {
  return sizeof(__nv_bfloat16) *
             ((size_t)2 * SFBW_CH * SFBW_WS + 2 * SFBW_ROWS * SFBW_XS) +
         sizeof(float) * (SFBW_MID + SFBW_CH);
}

// The flat [rows][cols] array src into the shared plane dst at [col][row]
// (row stride `stride`), by the threads of the block: 16-byte loads, four
// in flight, where src is 16-byte aligned, else (and for the last
// rows * cols % 8 elements) one element at a time.
__device__ __forceinline__ void stage_transposed(
    __nv_bfloat16* __restrict__ dst, int stride,
    const __nv_bfloat16* __restrict__ src, int rows, int cols) {
  constexpr int U = 4;
  const int total = rows * cols;
  const int body = reinterpret_cast<uintptr_t>(src) % 16 == 0
                       ? total / 8 * 8 : 0;
  const int step = 8 * blockDim.x;
  for (int e0 = 8 * threadIdx.x; e0 < body; e0 += U * step) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * step < body)
        v[u] = *reinterpret_cast<const uint4*>(src + e0 + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * step;
      if (e >= body) break;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
      int r = e / cols, c = e % cols;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dst[c * stride + r] = ve[k];
        if (++c == cols) c = 0, ++r;
      }
    }
  }
  for (int e = body + threadIdx.x; e < total; e += blockDim.x)
    dst[(e % cols) * stride + e / cols] = src[e];
}

template <int KS, int NT>
__global__ void __launch_bounds__(SFBW_WARPS * 32, SFBW_MINB)
seg_fwd_bf16_wide_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2,
                         const float* __restrict__ b2,
                         __nv_bfloat16* __restrict__ d, int n, int c_in,
                         int c_mid, int c_dec) {
  using E = __nv_bfloat16;
  constexpr int NTH = SFBW_WARPS * 32, MT = SFBW_MT, ROWS = SFBW_ROWS;
  constexpr int XS = SFBW_XS, WS = SFBW_WS, K = 16 * KS;
  constexpr int NP = (NT + 1) / 2;      // ldmatrix.x4 of W2 a step
  constexpr int NF = KS + NP;           // a step's ldmatrix.x4
  static_assert(K <= SFBW_CH && 16 * NP <= SFBW_CH, "widths");
  static_assert(16 * MT * XS >= 7 + 16 * MT * SFBW_CH, "a warp's d span");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* w1s = reinterpret_cast<E*>(smem_raw);   // [CH][WS]  w1[k][j] as it is
  E* w2s = w1s + SFBW_CH * WS;               // [CH][WS]  w2[j][c] at [c][j]
  E* xb = w2s + SFBW_CH * WS;                // [2][ROWS][XS]  x tiles, d
  float* b1s = reinterpret_cast<float*>(xb + 2 * ROWS * XS);   // [MID]
  float* b2s = b1s + SFBW_MID;                                 // [CH]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const E zero = __float2bfloat16_rn(0.f);

  const bool xvec = c_in % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  // Columns 0 .. K - 1 of the rows of tile t into buffer `buf`, zeros from
  // c_in on and past n: 16-byte cp.async where `xvec`, else plain copies.
  auto stage = [&](long t, int buf) {
    const E* src = x + t * ROWS * c_in;
    const int nr = (int)min((long)ROWS, (long)n - t * ROWS);
    E* dst = xb + buf * ROWS * XS;
    if (xvec) {
      constexpr int C8 = K / 8;
      for (int e = tid; e < ROWS * C8; e += NTH) {
        const int r = e / C8, c = 8 * (e % C8);
        const bool in = r < nr && c < c_in;
        probav::cp_async16_zfill(dst + r * XS + c,
                                 in ? src + r * c_in + c : src, in);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < ROWS * K; e += NTH) {
        const int r = e / K, c = e % K;
        dst[r * XS + c] = (r < nr && c < c_in) ? src[r * c_in + c] : zero;
      }
    }
  };

  // The first tile's rows are on their way while the weights are staged.
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  {
    uint4* p = reinterpret_cast<uint4*>(w1s);
    for (int e = tid; e < 2 * SFBW_CH * WS / 8; e += NTH)
      p[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int j = tid; j < SFBW_MID; j += NTH) b1s[j] = j < c_mid ? b1[j] : 0.f;
  if (tid < SFBW_CH) b2s[tid] = tid < c_dec ? b2[tid] : 0.f;
  __syncthreads();                            // the planes' zeros first
  // W1's rows as they lie in memory: 16-byte cp.async where c_mid % 8 == 0
  // and w1 is 16-byte aligned, else element copies.
  if (c_mid % 8 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0) {
    const int c8 = c_mid / 8;
    for (int e = tid; e < c_in * c8; e += NTH) {
      const int k = e / c8, j = 8 * (e % c8);
      probav::cp_async16_zfill(w1s + k * WS + j, w1 + k * c_mid + j, true);
    }
    cp_async_commit();
  } else {
    for (int e = tid; e < c_in * c_mid; e += NTH)
      w1s[e / c_mid * WS + e % c_mid] = w1[e];
  }
  stage_transposed(w2s, WS, w2, c_mid, c_dec);

  // This lane's ldmatrix rows: x's A tiles (rows lane % 16, 16 bytes of
  // columns from lane / 16 on); W1's B tiles by .trans, load i of a step
  // reading matrix m = 4 i + lane / 8 (input 8 (m % 2KS) + lane % 8,
  // middle channels from 8 (m / 2KS) on); W2's (output 8 (lane / 16) +
  // lane % 8, middle channels from 8 ((lane / 8) % 2) on).
  const int xoff = (lane % 8 + 8 * ((lane / 8) % 2)) * XS + 8 * (lane / 16);
  int w1off[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int m = 4 * i + lane / 8;
    w1off[i] = (8 * (m % (2 * KS)) + lane % 8) * WS + 8 * (m / (2 * KS));
  }
  const int w2off = (8 * (lane / 16) + lane % 8) * WS + 8 * ((lane / 8) % 2);
  const int steps = (c_mid + 15) / 16;
  const int rw = warp * 16 * MT;              // this warp's rows of a tile

  // Step s's fragments: f[i] = W1's load i, whose register r is matrix
  // m = 4 i + r, the B of middle channels 16 s + 8 t .. + 7 at inputs
  // 8 k8 .. + 7 (t = m / 2KS, k8 = m % 2KS); f[KS + p] = W2's of outputs
  // 16 p .. 16 p + 15 (registers: outputs 16 p .. + 7 at middle channels
  // 16 s .. + 7 and + 8 .. + 15, then outputs 16 p + 8 ..).
  auto load = [&](uint32_t (&f)[NF][4], int s) {
#pragma unroll
    for (int i = 0; i < KS; ++i)
      ldsm_x4_trans(f[i], w1s + 16 * s + w1off[i]);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldsm_x4(f[KS + p], w2s + 16 * p * WS + 16 * s + w2off);
  };

  int buf = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    // This tile's rows have landed, every warp is done with the other
    // buffer (its x and its d spans), and (the first time) the weights
    // are staged.
    __syncthreads();
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    E* xt = xb + (buf * ROWS + rw) * XS;

    uint32_t ax[MT][KS][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(ax[m][ks], xt + m * 16 * XS + 16 * ks + xoff);
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ct = 0; ct < NT; ++ct)
        acc[m][ct][0] = acc[m][ct][1] = acc[m][ct][2] = acc[m][ct][3] = 0.f;

    auto step = [&](const uint32_t (&f)[NF][4], int s) {
      const float2 bb0 = *reinterpret_cast<const float2*>(b1s + 16 * s +
                                                           2 * q);
      const float2 bb1 = *reinterpret_cast<const float2*>(b1s + 16 * s + 8 +
                                                           2 * q);
      float z[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        z[m][0][0] = z[m][0][2] = bb0.x, z[m][0][1] = z[m][0][3] = bb0.y;
        z[m][1][0] = z[m][1][2] = bb1.x, z[m][1][1] = z[m][1][3] = bb1.y;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            mma_bf16(z[m][t], ax[m][ks], f[(KS * t + ks) / 2]
                                              [2 * ((KS * t + ks) % 2)],
                     f[(KS * t + ks) / 2][2 * ((KS * t + ks) % 2) + 1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // relu, rounded to bf16 before the decay (pallas_tstack.py:237-238).
        const uint32_t ah[4] = {relu_bf16x2(z[m][0][0], z[m][0][1]),
                                relu_bf16x2(z[m][0][2], z[m][0][3]),
                                relu_bf16x2(z[m][1][0], z[m][1][1]),
                                relu_bf16x2(z[m][1][2], z[m][1][3])};
#pragma unroll
        for (int ct = 0; ct < NT; ++ct)
          mma_bf16(acc[m][ct], ah, f[KS + ct / 2][2 * (ct % 2)],
                   f[KS + ct / 2][2 * (ct % 2) + 1]);
      }
    };

    uint32_t fa[NF][4], fb[NF][4];
    load(fa, 0);
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {      // uniform over the block
      if (s + 1 < steps) load(fb, s + 1);
      step(fa, s);
      if (s + 1 >= steps) break;
      if (s + 2 < steps) load(fa, s + 2);
      step(fb, s + 1);
    }

    // d = acc + b2, rounded, staged as the span of this warp's rows (rows
    // r0 .. r0 + 16 MT - 1 are contiguous in d) in its rows of the x tile,
    // then stored.
    const long r0 = tile * ROWS + rw;
    const int nr = (int)max(0L, min((long)(16 * MT), (long)n - r0));
    E* dst = d + r0 * c_dec;
    const int skew = (int)((reinterpret_cast<uintptr_t>(dst) & 15) /
                           sizeof(E));
    __syncwarp();                             // every lane's x read
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int ct = 0; ct < NT; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * m + g + 8 * (i / 2), c = 8 * ct + 2 * q + i % 2;
          if (c < c_dec)
            xt[skew + r * c_dec + c] =
                __float2bfloat16_rn(acc[m][ct][i] + b2s[c]);
        }
    __syncwarp();
    store_span_warp(dst, xt, skew, nr * c_dec, lane);
  }
}

template <int KS, int NT>
cudaError_t launch_seg_fwd_bf16_wide_as(const void* x, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, void* d, int n,
                                        int c_in, int c_mid, int c_dec,
                                        cudaStream_t s) {
  constexpr size_t smem = seg_fwd_bf16_wide_smem();
  auto kern = seg_fwd_bf16_wide_kernel<KS, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      SFBW_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const long tiles = ((long)n + SFBW_ROWS - 1) / SFBW_ROWS;
  const long grid = std::min(tiles, (long)std::max(per_sm, 1) * sm_count());
  kern<<<(unsigned)grid, SFBW_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(d), n, c_in, c_mid, c_dec);
  return cudaGetLastError();
}

cudaError_t launch_seg_fwd_bf16_wide(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* d, int n,
                                     int c_in, int c_mid, int c_dec,
                                     cudaStream_t s) {
  if (c_in > SFBW_CH || c_dec > SFBW_CH || c_mid > SFBW_MID)
    return cudaErrorInvalidValue;
  if (c_in <= 48 && c_dec <= 40)
    return launch_seg_fwd_bf16_wide_as<3, 5>(x, w1, b1, w2, b2, d, n, c_in,
                                             c_mid, c_dec, s);
  if (c_dec <= 56)
    return launch_seg_fwd_bf16_wide_as<4, 7>(x, w1, b1, w2, b2, d, n, c_in,
                                             c_mid, c_dec, s);
  return launch_seg_fwd_bf16_wide_as<4, 8>(x, w1, b1, w2, b2, d, n, c_in,
                                           c_mid, c_dec, s);
}

// conv_fwd: an implicit GEMM on the tensor cores, M = positions, N = 8*NT
// output channels, K = 27 taps x CK decay channels (zero-padded to 32, 64,
// 96 or 128), over a ring of halo rows in shared memory.  One kernel for
// both dtypes, E the element type:
//
// - bf16: mma.sync m16n8k16 on bf16 operands, float32 accumulators.
// - float32: 3xTF32 on mma.sync m16n8k8.  Each operand v splits into hi =
//   v rounded to TF32 and lo = v - hi (split_tf32), and acc += lo_a hi_b +
//   hi_a lo_b + hi_a hi_b in float32, lo_a lo_b dropped: each product keeps
//   about 2^-20 of relative error at most, within the float32 tolerance
//   (2e-5 of max|ref| against a float32 conv), which plain TF32 (2^-11) is
//   not.  The tensor cores sum with truncation, so hi_a hi_b goes to
//   partial sums of one plane tap (12 or 24 products) added in float32,
//   the small terms to a sum of their own.  A k-step of 8 channels takes
//   three products, so the float32 conv issues 6x the bf16 conv's mma for
//   the same shape.  Its bound at the flagship: 3 x 24.1 GFLOP at the
//   494.7 TFLOP/s TF32 peak, 0.146 ms (0.36 ms at the 67 TFLOP/s float32
//   peak of the CUDA cores).  The split is issue-bound work beside the
//   mma: with cvt.rna.tf32.f32 (four instructions each) the products took
//   about as long without their mma as with them, hence split_tf32's two.
//
// A k-step is 32 bytes of channels at a position (16 bf16, 8 float32), so
// both dtypes share every address: the ldmatrix.x4 of a 16-position A tile
// or of a pair of 8-column B tiles reads four 8x8 b16 matrices, 8 rows of
// 16 bytes each, and hands each lane the 32-bit word that either product's
// fragment layout (common.cuh) wants: for TF32, one float32 of row g at
// column q of each matrix.
//
// - Work items are (b, run of `run` consecutive h rows, run of `wcols`
//   consecutive w columns); whole rows (wcols = W) where they fit.  The
//   launcher picks the h run so that one wave of blocks holds the items (the
//   whole of H, one item per SM, at B * column runs >= the SM count).  A
//   block walks down its h run ROWS output rows per step: rows h ..
//   h+ROWS-1 read input rows h-1 .. h+ROWS from ring slots (row hh in slot
//   hh % (ROWS+2), a zero-padded [wcols+2][T+2][CSP] block of d: the run's
//   columns and one halo column on each side; rows outside [0, H) read one
//   zero slot that is never written), while the next step's ROWS rows of d
//   and this step's rows of x are on their way in by cp.async.  Each row of
//   d thus crosses from memory once per h run, (run+2)/run times in all
//   (times (wcols+2)/wcols for the halo columns), and its copy overlaps the
//   products of the step before.
// - The copy: in [B, H, W, T, C] the columns w0-1 .. w0+wcols of a row are
//   one contiguous span of d (clipped at w = 0 and w = W), aligned to one
//   element only; it lands whole in a raw buffer by 16-byte cp.async from
//   the 16-byte chunk below its start (with whole rows, a step's rows of d
//   are one span, and so are its rows of x and of out), and each thread
//   then repacks 16 bytes of channels of one position at a time into the
//   slot.  Every chunk read holds an element of the span, so no read
//   leaves its pages.  The repack of a run of columns writes every slot
//   column, zeros for columns outside [0, W); that of a whole row only its
//   W columns.  It writes zeros for channels c_dec..CK.  The slots' T
//   borders (and a whole row's edge columns) are zeroed once per block and
//   never written; channels CK..CSP are never read.
// - Fragments by ldmatrix.x4: one per 16-position x 32-byte A tile at a tap
//   offset, one per pair of 8-column B tiles (weights staged as [plane
//   tap][h tap][o][c]).  CSP = CK + 16 bytes makes the position stride 80,
//   144 or 272 bytes: the 8 rows of a matrix fall in distinct banks.  The
//   loop runs over the 9 (w, t) taps and the k-steps; at each it loads the
//   A tiles of the ROWS+2 input rows and the B tiles of the 3 h taps once
//   and makes all 3*ROWS products from them (float32: splits them, then
//   three sweeps of products over all accumulators, so that no product
//   waits on the one before), the next step's fragments loading meanwhile.
//   bf16 unrolls all 9 plane taps; float32, with three times the code per
//   k-step, loops over them.
// - M-tiles: a run's ceil(wcols*T/16) tiles are taken in passes of at most
//   RING_WARPS*MT tiles; the block has just enough warps (MT tiles each:
//   2 at bf16, 1 at float32, whose split operands take the registers) for
//   one pass.  At 22x9 bf16 that is 13 tiles on 7 warps: 198 of 224 mma
//   rows (88%) live.
// - Epilogue: the residual runs of x sit in the x/out buffer; each thread
//   adds bc and its accumulators to its own elements there, summed in
//   float32 and rounded once (bf16) or not at all (float32), and the runs
//   (wcols*T*C contiguous elements of a row) leave with 16-byte stores
//   (scalar at their two ends, or throughout where out and x differ in
//   16-byte alignment).  Without the residual (blk_bwd's dd conv) the
//   buffer just stages the result.
// - Layout (ring_layout): all 27 weight taps staged once per block before
//   3 at a time (restaged inside the tap loop); with either, whole rows
//   before column runs, and two output rows per step before one (two only
//   at NT = 4: the accumulators of two rows at NT = 8 would spill); a run
//   as wide as fits, of at least RING_MIN_RUN positions with 27 taps, the
//   runs of a row made equal to within a column.  Beyond CK = 64 only 3
//   taps and one row per step (ring_all_taps).
// - Output tiles: more than 8 * NT outputs (beyond 64) go to a second grid
//   axis, one block per tile of 8 * NT outputs and work item.  Each block
//   copies the whole run of x but stores only its own channels
//   (store_cols), so the tiles never write the same element.  NT = 8 takes
//   twice the weights of NT = 4; where its layout does not fit (float32 at
//   CK = 128 beyond T = 9's runs of 2 columns), tiles of 32 do.
//
// Shared memory at the flagship (22x9, 25 -> 32; the dd conv's 32 -> 25 the
// same).  bf16: weights 27*32*40*2 = 69,120 B, 5 slots of 24*11*40*2 =
// 21,120 B, two raw rows of d (2 x 9,936) and two of x/out (2 x 12,704):
// 220,000 B, whole rows, two per step.  float32: weights 27*32*36*4 =
// 124,416 B leave room for runs of 11 columns, one row per step: 4 slots of
// 13*11*36*4 = 20,592 B, a raw run of d (11,728) and one of x/out
// (12,704): 231,216 B.  One block per SM either way.  Envelope (227 KB):
// every W at c_dec, c_out <= 128; a launch is refused, with
// cudaErrorInvalidValue before it runs, only where one column with 3 weight
// taps and 32 outputs does not fit.  At the widest bucket, 128 -> 128
// channels, that is T > 20 for float32 (3 taps of 32 outputs, 50,688 B,
// four slots of 3 x (T+2) positions of 528 B, a raw column of d and one of
// x/out) and T > 46 for bf16; narrower widths reach further (float32 64 ->
// 64: T > 46; 25 -> 32: T > 99; bf16 25 -> 32: T > 189).
constexpr int RING_WARPS = 8;      // most warps per block
constexpr int RING_MIN_RUN = 64;   // least positions of a run, 27 taps

// Whether all 27 weight taps can be staged at once for CK input channels
// (never beyond 64: 27 taps of 32 outputs at CK = 96 take 179,712 B in
// bf16, leaving no room for a run of RING_MIN_RUN positions); two output
// rows per step likewise only up to 64.
__host__ __device__ constexpr bool ring_all_taps(int CK) { return CK <= 64; }

// Element offset in a buffer that lines its chunks up with dst's.
template <typename E>
__device__ __forceinline__ int row_skew(const E* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(E));
}

// dst[j] = buf[skew + j] for j < n; 16-byte stores where dst and buf line
// up, scalar ones at the span's ends.
template <typename E>
__device__ __forceinline__ void store_row(E* dst, const E* buf, int skew,
                                          int n) {
  constexpr int VE = 16 / sizeof(E);
  const int so = row_skew(dst);
  if (so != skew) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = buf[skew + j];
    return;
  }
  const int chunks = (so + n + VE - 1) / VE;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int j0 = VE * i - so;   // span index of the chunk's first element
    if (j0 >= 0 && j0 + VE <= n) {
      *reinterpret_cast<uint4*>(dst + j0) =
          *reinterpret_cast<const uint4*>(buf + VE * i);
    } else {
      for (int k = 0; k < VE; ++k)
        if (j0 + k >= 0 && j0 + k < n) dst[j0 + k] = buf[VE * i + k];
    }
  }
}

// dst[p * c_out + o] = buf[skew + p * c_out + o] for p < np and the block's
// output channels o0 <= o < o1 (an output tile of a wide conv: the other
// channels of the staged runs belong to other blocks).
template <typename E>
__device__ __forceinline__ void store_cols(E* dst, const E* buf, int skew,
                                           int np, int c_out, int o0,
                                           int o1) {
  const int nc = o1 - o0;
  for (int u = threadIdx.x; u < np * nc; u += blockDim.x) {
    const int p = u / nc, o = o0 + u % nc;
    dst[(long)p * c_out + o] = buf[skew + (long)p * c_out + o];
  }
}

// acc[r] += the products for output rows h + r (r < ROWS) of plane taps
// pt0 .. pt0 + NPT - 1 (dw * 3 + dt) over all three h taps, for this
// warp's NM live m-tiles.  in[i] is the slot of input row h - 1 + i; input
// i feeds output r through h tap i - r, so each A fragment is loaded once
// for up to three products and each B fragment once for all ROWS rows.
// NPT * KS k-steps, the fragments of each step loaded while the step before
// runs on the tensor cores.  wt: the staged weights [plane tap][h tap][o][c]
// plus this lane's B-row offset.
template <typename E, int CK, int NT, int ROWS, int MT, int NPT, int NM>
__device__ __forceinline__ void mma_planes(
    float (&acc)[ROWS][MT][NT][4], const E* (&in)[ROWS + 2],
    const int (&aoff)[MT], const E* wt, int pt0, int T2) {
  constexpr bool TF32 = std::is_same<E, float>::value;
  constexpr int VE = 16 / sizeof(E), KC = 2 * VE, KS = CK / KC;
  constexpr int CSP = CK + VE, NO = 8 * NT, NI = ROWS + 2;
  static_assert(KS % 2 == 0, "a plane tap's k-steps alternate buffers");
  if constexpr (NM > 0) {
    uint32_t a[2][NI][NM][4], b[2][3][NT / 2][4];
    // float32: hi_a hi_b goes to ph, reset at every plane tap and added to
    // acc there in float32, the small terms to pl, added at the end (the
    // tensor cores sum with truncation, so short chains on small partial
    // sums hold the float32 tolerance at any K; two chains also halve each
    // product's wait on the one before).
    float ph[ROWS][NM][NT][4], pl[ROWS][NM][NT][4];
    auto zero = [&](float (&v)[ROWS][NM][NT][4]) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int t = 0; t < NT; ++t)
            v[r][m][t][0] = v[r][m][t][1] = v[r][m][t][2] = v[r][m][t][3] =
                0.f;
    };
    auto add = [&](float (&v)[ROWS][NM][NT][4]) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][m][t][i] += v[r][m][t][i];
    };
    auto load = [&](int pt, int kk, int buf) {
      const int tap = pt0 + pt;
      const int toff = ((tap / 3) * T2 + tap % 3) * CSP + kk * KC;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int m = 0; m < NM; ++m)
          ldsm_x4(a[buf][i][m], in[i] + aoff[m] + toff);
#pragma unroll
      for (int dh = 0; dh < 3; ++dh)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp)
          ldsm_x4(b[buf][dh][jp],
                  wt + ((pt * 3 + dh) * NO + jp * 16) * CSP + kk * KC);
    };
    auto products = [&](int cur) {
      if constexpr (!TF32) {   // row by row, the h taps in turn (faster
                               // back to back than the h tap outermost)
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int jp = 0; jp < NT / 2; ++jp)
#pragma unroll
              for (int m = 0; m < NM; ++m) {
                const uint32_t(&b4)[4] = b[cur][dh][jp];
                mma_bf16(acc[r][m][2 * jp], a[cur][r + dh][m], b4[0], b4[1]);
                mma_bf16(acc[r][m][2 * jp + 1], a[cur][r + dh][m], b4[2],
                         b4[3]);
              }
      } else {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          uint32_t ah[ROWS][NM][4], al[ROWS][NM][4];
          uint32_t bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int m = 0; m < NM; ++m)
              split_tf32(a[cur][r + dh][m], ah[r][m], al[r][m]);
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp)
            split_tf32(b[cur][dh][jp], bh[jp], bl[jp]);
          // lo_a hi_b and hi_a lo_b to pl, hi_a hi_b to ph; one sweep
          // over all accumulators per term.
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int jp = 0; jp < NT / 2; ++jp)
#pragma unroll
              for (int r = 0; r < ROWS; ++r)
#pragma unroll
                for (int m = 0; m < NM; ++m)
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    const uint32_t(&fa)[4] = term == 0 ? al[r][m] : ah[r][m];
                    const uint32_t(&fb)[4] = term == 1 ? bl[jp] : bh[jp];
                    float(&c)[4] = term == 2 ? ph[r][m][2 * jp + half]
                                             : pl[r][m][2 * jp + half];
                    mma_tf32(c, fa, fb[2 * half], fb[2 * half + 1]);
                  }
        }
      }
    };
    auto plane = [&](int pt) {
      if constexpr (TF32) zero(ph);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk + 1 < KS)
          load(pt, kk + 1, (kk + 1) % 2);
        else if (pt + 1 < NPT)
          load(pt + 1, 0, 0);
        products(kk % 2);
      }
      if constexpr (TF32) add(ph);
    };
    load(0, 0, 0);
    if constexpr (TF32) {
      zero(pl);
#pragma unroll 1
      for (int pt = 0; pt < NPT; ++pt) plane(pt);
      add(pl);
    } else {
#pragma unroll
      for (int pt = 0; pt < NPT; ++pt) plane(pt);
    }
  }
}

template <typename E, int CK, int NT, int ROWS, int MT, bool RES>
__global__ void __launch_bounds__(RING_WARPS * 32)
conv_ring_kernel(const E* __restrict__ d, const E* __restrict__ x,
                 const E* __restrict__ wc, const float* __restrict__ bc,
                 E* __restrict__ out, int B, int H, int W, int Tn, int c_dec,
                 int c_out, int run, int wcols, int wtaps, int dbuf_elems,
                 int obuf_elems) {
  constexpr int VE = 16 / sizeof(E);  // elements per 16 bytes
  constexpr int CSP = CK + VE;        // channel stride of a slot position
  constexpr int NO = 8 * NT;
  constexpr int NS = ROWS + 2;        // ring slots (plus one zero slot)
  const int T2 = Tn + 2;
  // This block's output tile: channels o0 .. o1 - 1 (all of them at
  // c_out <= 8 * NT, a grid of one tile).
  const int o0 = blockIdx.y * NO, o1 = min(c_out, o0 + NO);
  const int slot_elems = (wcols + 2) * T2 * CSP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* ws = reinterpret_cast<E*>(smem_raw);
  E* slots = ws + wtaps * NO * CSP;       // [NS + 1][wcols+2][T+2][CSP]
  E* dbuf = slots + (NS + 1) * slot_elems;   // ROWS raw runs of d
  E* obuf = dbuf + ROWS * dbuf_elems;        // ROWS runs of x, then out
  const E* zslot = slots + NS * slot_elems;
  const E zero = probav::from_f<E>(0.f);
  const int tid = threadIdx.x, nthr = blockDim.x;

  // wc [27][c_dec][c_out] -> ws[plane tap][h tap][o - o0][c] for the
  // wtaps / 3 plane taps from pt0 on, read in wc's order, 8 loads in
  // flight.
  auto stage_w = [&](int pt0) {
    const int total = wtaps * CK * NO;
    for (int e0 = tid; e0 < total; e0 += 8 * nthr) {
      E v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        const int o = e % NO, rest = e / NO;
        const int c = rest % CK, lt = rest / CK;
        const int tap = (lt % 3) * 9 + pt0 + lt / 3;
        v[k] = (e < total && c < c_dec && o0 + o < c_out)
                   ? wc[((long)tap * c_dec + c) * c_out + o0 + o] : zero;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        const int o = e % NO, rest = e / NO;
        if (e < total) ws[((rest / CK) * NO + o) * CSP + rest % CK] = v[k];
      }
    }
  };
  // The run of row hh of d at element `src` of dbuf (its columns from
  // max(w0 - 1, 0) on) -> row hh's slot: slot column j holds column
  // w0 - 1 + j for j <= wl + 1, zero outside [0, W); channels 0..CK, zero
  // from c_dec; 16 bytes of a position per step.  Whole rows write only
  // the W columns inside: their edge columns stay as zeroed at the start.
  auto repack = [&](int hh, int src, int w0, int wl) {
    constexpr int G = CK / VE;              // 16-byte groups of a position
    E* slot = slots + (hh % NS) * slot_elems;
    const int clo = max(w0 - 1, 0), c0 = wl == W ? 1 : 0;
    const int n = (wl + 2 - 2 * c0) * Tn * G;
    for (int u = tid; u < n; u += nthr) {
      const int p = u / G, j = u - p * G;
      const int pc = p / Tn, t = p - pc * Tn, sc = pc + c0;
      const int w = w0 - 1 + sc;
      const bool live = w >= 0 && w < W;
      const E* s = dbuf + src + ((w - clo) * Tn + t) * c_dec + VE * j;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (VE == 8) {
          const int c = VE * j + 2 * k;
          v[k] = pack2(live && c < c_dec ? s[2 * k] : zero,
                       live && c + 1 < c_dec ? s[2 * k + 1] : zero);
        } else {
          const int c = VE * j + k;
          v[k] = __float_as_uint(live && c < c_dec ? s[k] : 0.f);
        }
      }
      *reinterpret_cast<uint4*>(slot + (sc * T2 + t + 1) * CSP + VE * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  // Start the copies of the runs of rows r .. r + n - 1 of d (columns
  // w0 - 1 .. w0 + wl, clipped to the volume); src[i] <- the element offset
  // in dbuf of row r + i's run.  Whole rows are one contiguous span, copied
  // at once; runs of columns go to raw buffer i each.
  auto copy_d = [&](long brow, int r, int n, int w0, int wl,
                    int (&src)[ROWS]) {
    const long wt = (long)Tn * c_dec;
    if (wl == W) {
      const int s =
          n > 0 ? copy_async(dbuf, d + (brow + r) * W * wt, n * W * wt) : 0;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) src[i] = s + i * W * (int)wt;
      return;
    }
    const int clo = max(w0 - 1, 0), chi = min(w0 + wl, W - 1);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      src[i] = i < n ? i * dbuf_elems +
                           copy_async(dbuf + i * dbuf_elems,
                                      d + ((brow + r + i) * W + clo) * wt,
                                      (chi - clo + 1) * (int)wt)
                     : 0;
  };

  for (int e = tid; e < (NS + 1) * slot_elems / VE; e += nthr)
    reinterpret_cast<uint4*>(slots)[e] = make_uint4(0, 0, 0, 0);
  if (ring_all_taps(CK) && wtaps == 27)
    stage_w(0);   // visible after the first row's barrier

  const int lane = tid % 32, warp = tid / 32, nw = nthr / 32;
  const int g = lane / 4, q = lane % 4;
  // This lane's ldmatrix row of the B tiles: o = 8 * (lane / 16) + lane % 8,
  // channels from 16 bytes * ((lane / 8) % 2) on.
  const int boff = (8 * (lane / 16) + lane % 8) * CSP + VE * ((lane / 8) % 2);
  float bcv[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int o = o0 + t * 8 + 2 * q + k;
      bcv[t][k] = (RES && o < c_out) ? bc[o] : 0.f;
    }

  const int hruns = (H + run - 1) / run, wruns = (W + wcols - 1) / wcols;
  const long items = (long)B * hruns * wruns;
  for (long item = blockIdx.x; item < items; item += gridDim.x) {
    const long brow = item / (hruns * wruns) * H;   // b * H
    const int ir = (int)(item % (hruns * wruns));
    const int h0 = ir / wruns * run, w0 = ir % wruns * wcols;
    const int wl = min(wcols, W - w0), np = wl * Tn;  // the run's columns
    const int h1 = min(H, h0 + run);
    const int top = min(H - 1, h1);                 // last input row
    for (int r = max(0, h0 - 1); r <= min(top, h0 + ROWS); r += ROWS) {
      const int n = min(ROWS, min(top, h0 + ROWS) - r + 1);
      int src[ROWS];
      copy_d(brow, r, n, w0, wl, src);
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (i < n) repack(r + i, src[i], w0, wl);
      __syncthreads();
    }

    const int tiles = (np + 15) / 16;
    for (int h = h0; h < h1; h += ROWS) {
      // Output rows h .. h + nout - 1; rows past h1 (an odd run's last
      // step) are computed from whatever their slots hold and not stored.
      const int nout = min(ROWS, h1 - h);
      const int nlo = h + ROWS + 1;                 // the next step's rows
      const int nn = max(0, min(top, h + 2 * ROWS) - nlo + 1);
      // Runs of x (or of out's alignment) for the output rows: with whole
      // rows one span from obuf on, else one run per raw buffer; obase[i]
      // is the element offset in obuf of output row h + i's run.
      int dsrc[ROWS], obase[ROWS];
      long orow[ROWS];
      copy_d(brow, nlo, nn, w0, wl, dsrc);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        orow[i] = ((brow + h + i) * W + w0) * (long)Tn * c_out;
      if (wl == W) {
        const int s = RES ? copy_async(obuf, x + orow[0], nout * np * c_out)
                          : row_skew(out + orow[0]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) obase[i] = s + i * np * c_out;
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          obase[i] = i * obuf_elems +
                     (i >= nout ? 0
                      : RES ? copy_async(obuf + i * obuf_elems, x + orow[i],
                                         np * c_out)
                            : row_skew(out + orow[i]));
      }
      cp_async_commit();
      const E* in[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hh = h - 1 + i;
        in[i] = (hh >= 0 && hh < H) ? slots + (hh % NS) * slot_elems : zslot;
      }

      for (int t0 = 0; t0 < tiles; t0 += nw * MT) {
        int aoff[MT];
        bool live[MT];
        float acc[ROWS][MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int tm = t0 + warp * MT + m;
          live[m] = tm < tiles;
          // ldmatrix row of the A tile: position 16 tm + lane % 16,
          // channels from 16 bytes * (lane / 16) on; past the run,
          // position 0 (its results are never stored).
          int p = tm * 16 + lane % 16;
          if (p >= np) p = 0;
          aoff[m] = ((p / Tn) * T2 + p % Tn) * CSP + VE * (lane / 16);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int t = 0; t < NT; ++t)
              acc[r][m][t][0] = acc[r][m][t][1] = acc[r][m][t][2] =
                  acc[r][m][t][3] = 0.f;
        }

        // The products, for this warp's count of live m-tiles (warp-
        // uniform, so the unrolled loops carry no conditions).
        auto taps = [&](auto live_tiles) {
          constexpr int NM = decltype(live_tiles)::value;
          if constexpr (ring_all_taps(CK)) {
            if (wtaps == 27) {
              mma_planes<E, CK, NT, ROWS, MT, 9, NM>(acc, in, aoff,
                                                     ws + boff, 0, T2);
              return;
            }
          }
          for (int pt = 0; pt < 9; ++pt) {   // one plane tap's 3 h taps
            __syncthreads();
            stage_w(pt);
            __syncthreads();
            mma_planes<E, CK, NT, ROWS, MT, 1, NM>(acc, in, aoff, ws + boff,
                                                   pt, T2);
          }
        };
        const int nlive = tiles - t0 - warp * MT;
        if (nlive >= MT)
          taps(std::integral_constant<int, MT>());
        else if (nlive == 1)
          taps(std::integral_constant<int, 1>());
        else
          taps(std::integral_constant<int, 0>());

        if (t0 == 0) {   // the copies have had the first pass to land
          cp_async_wait_all();
          __syncthreads();
        }
        // out = acc + bc + x (RES) or acc, in float32, rounded once.
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= nout) break;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (!live[m]) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int p = (t0 + warp * MT + m) * 16 + g + (i < 2 ? 0 : 8);
              if (p >= np) continue;
#pragma unroll
              for (int t = 0; t < NT; ++t) {
                const int o = o0 + t * 8 + 2 * q + (i & 1);
                if (o >= c_out) continue;
                E& e = obuf[obase[r] + p * c_out + o];
                const float v = acc[r][m][t][i];
                e = probav::from_f<E>(
                    RES ? v + bcv[t][i & 1] + probav::to_f(e) : v);
              }
            }
          }
        }
      }

      __syncthreads();   // the step's slots read, its out runs staged
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (i < nn) repack(nlo + i, dsrc[i], w0, wl);
      if (gridDim.y > 1) {   // an output tile: its own channels only
        if (wl == W) {
          store_cols(out + orow[0], obuf, obase[0], nout * np, c_out, o0, o1);
        } else {
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            if (i < nout)
              store_cols(out + orow[i], obuf + i * obuf_elems,
                         obase[i] - i * obuf_elems, np, c_out, o0, o1);
        }
      } else if (wl == W) {
        store_row(out + orow[0], obuf, obase[0], nout * np * c_out);
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
          if (i < nout)
            store_row(out + orow[i], obuf + i * obuf_elems,
                      obase[i] - i * obuf_elems, np * c_out);
      }
      __syncthreads();   // dbuf and obuf free for the next step's copies
    }
  }
}

// Column runs of d and of x/out of a layout, for its raw buffers.
struct RingLayout {
  int rows, wtaps, wcols;
};

// Shared-memory bytes of conv_ring_kernel<E, CK, NT, rows> at runs of
// `wcols` of the W columns with `wtaps` weight taps staged; the raw
// buffers' elements in *dbuf, *obuf.
template <typename E, int CK, int NT>
size_t ring_smem(const RingLayout& l, int W, int Tn, int c_dec, int c_out,
                 int* dbuf = nullptr, int* obuf = nullptr) {
  constexpr int CSP = CK + 16 / (int)sizeof(E);
  const size_t dcols = (size_t)std::min(W, l.wcols + 2);
  const size_t db = run_buf_bytes(sizeof(E) * dcols * Tn * c_dec);
  const size_t ob = run_buf_bytes(sizeof(E) * (size_t)l.wcols * Tn * c_out);
  if (dbuf) *dbuf = (int)(db / sizeof(E));
  if (obuf) *obuf = (int)(ob / sizeof(E));
  return sizeof(E) * ((size_t)l.wtaps * 8 * NT * CSP +
                      (size_t)(l.rows + 3) * (l.wcols + 2) * (Tn + 2) * CSP) +
         l.rows * (db + ob);
}

// The layout of conv_ring_kernel for a volume (see above); false where not
// even one column fits with 3 weight taps.
template <typename E, int CK, int NT>
bool ring_layout(int W, int Tn, int c_dec, int c_out, size_t cap,
                 RingLayout* out) {
  constexpr int MAX_ROWS = NT == 4 && ring_all_taps(CK) ? 2 : 1;
  for (int wtaps : {27, 3}) {
    if (wtaps == 27 && !ring_all_taps(CK)) continue;
    for (int rows = MAX_ROWS; rows >= 1; --rows) {
      RingLayout l{rows, wtaps, W};
      if (ring_smem<E, CK, NT>(l, W, Tn, c_dec, c_out) <= cap) {
        *out = l;   // whole rows
        return true;
      }
    }
    for (int rows = MAX_ROWS; rows >= 1; --rows) {
      // The widest run that fits (the bytes grow with the run).
      int lo = 0, hi = W - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (ring_smem<E, CK, NT>(RingLayout{rows, wtaps, mid}, W, Tn, c_dec,
                                 c_out) <= cap)
          lo = mid;
        else
          hi = mid - 1;
      }
      if (lo < 1 || (wtaps == 27 && lo * Tn < RING_MIN_RUN)) continue;
      const int runs = (W + lo - 1) / lo;
      *out = RingLayout{rows, wtaps, (W + runs - 1) / runs};
      return true;
    }
  }
  return false;
}

template <typename E, int CK, int NT, int ROWS, bool RES>
cudaError_t launch_conv_ring(const void* d, const void* x, const void* wc,
                             const void* bc, void* out, int B, int H, int W,
                             int Tn, int c_dec, int c_out,
                             const RingLayout& lay, cudaStream_t s) {
  constexpr int MT = std::is_same<E, float>::value ? 1 : 2;
  const int tiles = (lay.wcols * Tn + 15) / 16;
  const int per_pass = RING_WARPS * MT;
  const int passes = (tiles + per_pass - 1) / per_pass;
  const int warps = (tiles + passes * MT - 1) / (passes * MT);
  const int otiles = (c_out + 8 * NT - 1) / (8 * NT);
  int dbuf = 0, obuf = 0;
  const size_t smem =
      ring_smem<E, CK, NT>(lay, W, Tn, c_dec, c_out, &dbuf, &obuf);
  auto kern = conv_ring_kernel<E, CK, NT, ROWS, MT, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  // One wave of blocks, shared among the output tiles.
  const long resident = std::max(
      1L, (long)(per_sm > 0 ? per_sm : 1) * sm_count() / otiles);
  // h run length: the least work for the busiest wave of blocks, counting
  // a row's products twice (steps of ROWS rows) and its copy once.
  const long bw = (long)B * ((W + lay.wcols - 1) / lay.wcols);
  int run = H;
  long best = -1;
  for (int r = H; r >= 1; --r) {
    const long items = bw * ((H + r - 1) / r);
    const long steps = (r + ROWS - 1) / ROWS;
    const long cost = (items + resident - 1) / resident *
                      (2 * ROWS * steps + r + 2);
    if (best < 0 || cost < best) best = cost, run = r;
  }
  const long items = bw * ((H + run - 1) / run);
  const dim3 grid((unsigned)(items < resident ? items : resident), otiles);
  kern<<<grid, warps * 32, smem, s>>>(
      static_cast<const E*>(d), static_cast<const E*>(x),
      static_cast<const E*>(wc), static_cast<const float*>(bc),
      static_cast<E*>(out), B, H, W, Tn, c_dec, c_out, run, lay.wcols,
      lay.wtaps, dbuf, obuf);
  return cudaGetLastError();
}

template <typename E, int CK, int NT, bool RES>
cudaError_t launch_ring_layout(const void* d, const void* x, const void* wc,
                               const void* bc, void* out, int B, int H, int W,
                               int Tn, int c_dec, int c_out,
                               const RingLayout& lay, cudaStream_t s) {
  if constexpr (NT == 4 && ring_all_taps(CK)) {
    if (lay.rows == 2)
      return launch_conv_ring<E, CK, NT, 2, RES>(d, x, wc, bc, out, B, H, W,
                                                 Tn, c_dec, c_out, lay, s);
  }
  return launch_conv_ring<E, CK, NT, 1, RES>(d, x, wc, bc, out, B, H, W, Tn,
                                             c_dec, c_out, lay, s);
}

// Decay channels padded to CK = 32, 64, 96 or 128; outputs in tiles of 8 *
// NT channels, one block per tile and work item: NT = 4 up to 32 outputs,
// else NT = 8 (tiles of 64) where a layout fits, else NT = 4 (tiles of 32,
// less shared memory for weights: float32 at CK = 128 and T = 19).  A
// volume for which neither fits is refused (cudaErrorInvalidValue) before
// any launch.
template <typename E, bool RES>
cudaError_t dispatch_conv_ring(const void* d, const void* x, const void* wc,
                               const void* bc, void* out, int B, int H,
                               int W, int Tn, int c_dec, int c_out,
                               cudaStream_t s) {
  if (c_dec < 1 || c_dec > probav::MAX_CH || c_out < 1 ||
      c_out > probav::MAX_CH)
    return cudaErrorInvalidValue;
  const size_t optin = (size_t)probav::optin_smem();
  return probav::by_bucket(c_dec, [&](auto ck) {
    constexpr int CK = decltype(ck)::value;
    RingLayout lay;
    if (c_out > 32 && ring_layout<E, CK, 8>(W, Tn, c_dec, c_out, optin, &lay))
      return launch_ring_layout<E, CK, 8, RES>(d, x, wc, bc, out, B, H, W, Tn,
                                               c_dec, c_out, lay, s);
    if (ring_layout<E, CK, 4>(W, Tn, c_dec, c_out, optin, &lay))
      return launch_ring_layout<E, CK, 4, RES>(d, x, wc, bc, out, B, H, W, Tn,
                                               c_dec, c_out, lay, s);
    return cudaErrorInvalidValue;   // outside the envelope
  });
}

}  // namespace

cudaError_t probav::conv_dispatch(int dtype, bool residual, const void* d,
                                  const void* x, const void* wc,
                                  const void* bc, void* out, int B, int H,
                                  int W, int Tn, int c_dec, int c_out,
                                  cudaStream_t s) {
  if (dtype == 0)
    return residual ? dispatch_conv_ring<float, true>(d, x, wc, bc, out, B,
                                                      H, W, Tn, c_dec, c_out,
                                                      s)
                    : dispatch_conv_ring<float, false>(d, x, wc, bc, out, B,
                                                       H, W, Tn, c_dec, c_out,
                                                       s);
  if (dtype == 1)
    return residual ? dispatch_conv_ring<__nv_bfloat16, true>(
                          d, x, wc, bc, out, B, H, W, Tn, c_dec, c_out, s)
                    : dispatch_conv_ring<__nv_bfloat16, false>(
                          d, x, wc, bc, out, B, H, W, Tn, c_dec, c_out, s);
  return cudaErrorInvalidValue;
}

// seg_fwd_route sends both dtypes to their wide kernels up to the same
// widths.
static_assert(SFBW_CH == SFW_CH && SFBW_MID == SFW_MID,
              "seg_fwd_route gives both wide kernels the same widths");

extern "C" {

// dtype: 0 = float32 (tensor cores as 3xTF32 at c_in, c_dec <= 32 and
// c_mid <= 256, and up to 64 and 512 in chunks of C_mid, else CUDA cores:
// seg_fwd_route), 1 = bfloat16 (tensor cores: seg_fwd_bf16_kernel within
// the same widths, seg_fwd_bf16_wide_kernel up to 64 and 512, else
// seg_fwd_mma_kernel).  x, w1, w2, d in that dtype; b1, b2 in float32.
// c_in, c_dec any count from 1 to MAX_CH = 128; c_mid any positive count
// (staged in chunks).
int probav_seg_fwd(int dtype, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* d, int n, int c_in,
                   int c_mid, int c_dec, void* stream) {
  if (n < 0 || c_in < 1 || c_in > probav::MAX_CH || c_dec < 1 ||
      c_dec > probav::MAX_CH || c_mid < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_fwd_route(dtype, c_in, c_mid, c_dec)) {
    case SEG_FWD_BF16_MMA:
      return (int)dispatch_seg_mma(x, w1, b1, w2, b2, d, n, c_in, c_mid,
                                   c_dec, s);
    case SEG_FWD_BF16_LDSM:
      return (int)launch_seg_fwd_bf16(x, w1, b1, w2, b2, d, n, c_in, c_mid,
                                      c_dec, s);
    case SEG_FWD_TF32_MMA:
      return (int)launch_seg_fwd_tf32(x, w1, b1, w2, b2, d, n, c_in, c_mid,
                                      c_dec, s);
    case SEG_FWD_TF32_WIDE:
      return (int)launch_seg_fwd_tf32_wide(x, w1, b1, w2, b2, d, n, c_in,
                                           c_mid, c_dec, s);
    case SEG_FWD_BF16_WIDE:
      return (int)launch_seg_fwd_bf16_wide(x, w1, b1, w2, b2, d, n, c_in,
                                           c_mid, c_dec, s);
    default:
      return (int)dispatch_seg(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec,
                               s);
  }
}

// The kernel probav_seg_fwd launches for these widths: 0 = seg_fwd_kernel
// (CUDA cores), 1 = seg_fwd_mma_kernel (bf16 mma), 2 = seg_fwd_tf32_kernel
// (float32 as 3xTF32 mma), 3 = seg_fwd_bf16_kernel (bf16 mma, ldmatrix),
// 4 = seg_fwd_tf32_wide_kernel (float32 as 3xTF32 mma, C_mid in chunks),
// 5 = seg_fwd_bf16_wide_kernel (bf16 mma, ldmatrix, weights staged once a
// block).
int probav_seg_fwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  return (int)seg_fwd_route(dtype, c_in, c_mid, c_dec);
}

// dtype: 0 = float32 (tensor cores, 3xTF32), 1 = bfloat16 (tensor
// cores).  d, x, wc, out in that dtype; bc in float32.  wc is [3, 3, 3,
// c_dec, c_out] (taps over H, W, T), c_dec and c_out from 1 to MAX_CH =
// 128.  Any W; a T beyond the envelope of conv_ring_kernel (one column with
// 3 weight taps over shared memory: T > 20 at float32, 128 -> 128
// channels) is refused.
int probav_conv_fwd(int dtype, const void* d, const void* x, const void* wc,
                    const void* bc, void* out, int B, int H, int W, int Tn,
                    int c_dec, int c_out, void* stream) {
  if (B < 0 || H < 1 || W < 1 || Tn < 1 || c_dec < 1 ||
      c_dec > probav::MAX_CH || c_out < 1 || c_out > probav::MAX_CH)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  return (int)probav::conv_dispatch(dtype, true, d, x, wc, bc, out, B, H, W,
                                    Tn, c_dec, c_out,
                                    static_cast<cudaStream_t>(stream));
}

const char* probav_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
