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
// kept here.  conv_fwd at the flagship (128 patches of 22x22x9, 25 -> 32:
// N = 557,568 positions) reads d (27.9 MB) and x (35.7 MB) and writes out
// (35.7 MB): 99 MB, 0.0296 ms at 3.35 TB/s; its 24.1 GFLOP (30.8 with the
// decay channels padded to 32) take 0.024 ms at the bf16 tensor peak, so
// in bf16 it is bound by bytes, and in float32 (0.36 ms at 67 TFLOP/s) by
// operations.
//
// - float32 runs on the CUDA cores (exact float32 products, as the JAX
//   reference computes).  seg_fwd: each thread owns one row, holds x and
//   the d accumulator in registers and makes the wide activation one
//   channel at a time; weights are staged in shared memory in chunks of
//   SEG_MCH middle channels and read as broadcast float4 loads.  conv_fwd:
//   a block owns up to 256 positions of one (b, h) row of the volume; for
//   each h tap it stages the zero-padded [W+2, T+2, C_dec] halo row and
//   the nine [C_dec, C_out] tap weights; each thread accumulates all C_out
//   outputs of its position in registers.
// - bf16 runs on the tensor cores (mma.sync m16n8k16, float32
//   accumulators): seg_fwd chains the expand and decay products in
//   registers; conv_fwd is an implicit GEMM over a shared-memory ring of
//   halo rows, each row of d read from memory about once, filled by
//   cp.async while the tensor cores work, fragments by ldmatrix, two output
//   rows per step sharing every fragment load (conv_ring_kernel below,
//   with its shared-memory budget and shape envelope).  blk_bwd.cu's dd
//   conv runs the same kernel through probav::conv_dispatch.
//
// Both round where the TPU kernels round: sums in float32, the relu output
// cast to the compute dtype before the decay product, outputs stored in
// the compute dtype.  wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (probav_tpu_torch/ops/_build.py):
// every entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the call that failed first).

#include "common.cuh"

#include <type_traits>

namespace {

using probav::lds32;
using probav::mma_bf16;
using probav::pack_bf16;
using probav::sm_count;

constexpr int SEG_ROWS = 256;   // rows per seg_fwd block = threads per block
constexpr int SEG_MCH = 64;     // middle channels staged per chunk
constexpr int CONV_POS = 256;   // max positions (threads) per conv_fwd block

// ------------------------------------------------------------------------ //
// seg_fwd, float32: x [n, c_in] -> d [n, c_dec]                             //
// CI, CD: register widths (>= c_in, c_dec); unused lanes see zero weights.  //
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

  float xr[CI];
#pragma unroll
  for (int k = 0; k < CI; ++k) xr[k] = rows[tid * RS + k];
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
      // Padded channels have zero weights and bias: they contribute nothing.
      const float h = fmaxf(z + b1s[j], 0.f);
      const float4* w2v = reinterpret_cast<const float4*>(w2s + j * CD);
#pragma unroll
      for (int q = 0; q < CD / 4; ++q) {
        const float4 w = w2v[q];
        acc[4 * q + 0] = fmaf(h, w.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(h, w.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(h, w.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(h, w.w, acc[4 * q + 3]);
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
  const bool ci32 = c_in <= 32, cd32 = c_dec <= 32;
  if (ci32 && cd32)
    return launch_seg<32, 32>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  if (ci32)
    return launch_seg<32, 64>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  if (cd32)
    return launch_seg<64, 32>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  return launch_seg<64, 64>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
}

// ------------------------------------------------------------------------ //
// conv_fwd, float32: d [B,H,W,T,c_dec], x [B,H,W,T,c_out] -> out            //
// CO: register width (>= c_out).                                            //
// ------------------------------------------------------------------------ //

template <int CO>
__host__ __device__ constexpr int conv_out_stride() { return CO + 1; }

__host__ __device__ inline int conv_halo_stride(int c_dec) {
  return c_dec | 1;   // odd: neighbouring positions hit different banks
}

template <int CO, bool RES>
__global__ void __launch_bounds__(CONV_POS)
conv_fwd_kernel(const float* __restrict__ d, const float* __restrict__ x,
                const float* __restrict__ wc, const float* __restrict__ bc,
                float* __restrict__ out, int H, int W, int Tn, int c_dec,
                int c_out, int halo_floats) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                     // [9][c_dec][CO]  taps of one dh
  float* buf = ws + 9 * c_dec * CO;     // halo row, later the output tile
  const int hs = conv_halo_stride(c_dec);
  const int W2 = W + 2, T2 = Tn + 2;

  const int bh = blockIdx.x;            // b * H + h
  const int h = bh % H;
  const int WT = W * Tn;
  const int p0 = blockIdx.y * CONV_POS;
  const int np = WT - p0 < CONV_POS ? WT - p0 : CONV_POS;
  const int tid = threadIdx.x;
  const int p = p0 + tid;
  const bool live = tid < np;
  const int pw = live ? p / Tn : 0, pt = live ? p % Tn : 0;

  float acc[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) acc[o] = 0.f;

  for (int dh = -1; dh <= 1; ++dh) {
    const int hh = h + dh;
    const bool row_in = hh >= 0 && hh < H;
    __syncthreads();   // previous dh's halo and weights fully consumed
    // Zero-padded halo row [W+2][T+2][hs] of d at height hh.
    const long src0 = ((long)(bh + dh) * WT) * c_dec;
    for (int e = tid; e < halo_floats; e += blockDim.x) {
      const int c = e % hs, wt = e / hs;
      const int ti = wt % T2, wi = wt / T2;
      float v = 0.f;
      if (row_in && c < c_dec && wi >= 1 && wi <= W && ti >= 1 && ti <= Tn)
        v = d[src0 + ((long)(wi - 1) * Tn + (ti - 1)) * c_dec + c];
      buf[e] = v;
    }
    // Tap weights for this dh: wc[(dh+1)*9 + tap][c][o] -> ws[tap][c][o].
    const long w0 = (long)(dh + 1) * 9 * c_dec * c_out;
    for (int e = tid; e < 9 * c_dec * CO; e += blockDim.x) {
      const int o = e % CO, tc = e / CO;
      ws[e] = o < c_out ? wc[w0 + (long)tc * c_out + o] : 0.f;
    }
    __syncthreads();
    if (!live || !row_in) continue;

    for (int tap = 0; tap < 9; ++tap) {
      const int dw = tap / 3, dt = tap % 3;   // 0..2 -> offsets -1..1
      const float* dv = buf + ((pw + dw) * T2 + (pt + dt)) * hs;
      const float* wt = ws + tap * c_dec * CO;
      for (int c = 0; c < c_dec; ++c) {
        const float v = dv[c];
        const float4* w4 = reinterpret_cast<const float4*>(wt + c * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = fmaf(v, w.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, w.w, acc[4 * q + 3]);
        }
      }
    }
  }

  // Epilogue through shared memory so that x is read and out written with
  // coalesced accesses: out = acc + bc + x (RES), else out = acc.
  __syncthreads();
  constexpr int OS = conv_out_stride<CO>();
  if (live) {
#pragma unroll
    for (int o = 0; o < CO; ++o) buf[tid * OS + o] = acc[o];
  }
  __syncthreads();
  const long r0 = ((long)bh * WT + p0) * c_out;
  for (int e = tid; e < np * c_out; e += blockDim.x) {
    const int r = e / c_out, o = e % c_out;
    const float v = buf[r * OS + o];
    out[r0 + e] = RES ? v + bc[o] + x[r0 + e] : v;
  }
}

template <int CO, bool RES>
cudaError_t launch_conv(const void* d, const void* x, const void* wc,
                        const void* bc, void* out, int B, int H, int W, int Tn,
                        int c_dec, int c_out, cudaStream_t stream) {
  const int WT = W * Tn;
  const int threads = (((WT < CONV_POS ? WT : CONV_POS) + 31) / 32) * 32;
  const int halo = (W + 2) * (Tn + 2) * conv_halo_stride(c_dec);
  const int outbuf = threads * conv_out_stride<CO>();
  const size_t smem =
      sizeof(float) * ((size_t)9 * c_dec * CO + (halo > outbuf ? halo : outbuf));
  auto kern = conv_fwd_kernel<CO, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (WT + CONV_POS - 1) / CONV_POS);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(d), static_cast<const float*>(x),
      static_cast<const float*>(wc), static_cast<const float*>(bc),
      static_cast<float*>(out), H, W, Tn, c_dec, c_out, halo);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t dispatch_conv(const void* d, const void* x, const void* wc,
                          const void* bc, void* out, int B, int H, int W,
                          int Tn, int c_dec, int c_out, cudaStream_t s) {
  if (c_out <= 32)
    return launch_conv<32, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec, c_out,
                                s);
  return launch_conv<64, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec, c_out, s);
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
// decay product d += h W2 (N = 8*NT2).  W1^T [c_mid][16*KS1] and
// W2^T [8*NT2][c_mid] are staged once per block in shared memory, rows
// padded by 8 elements so that the fragment loads hit distinct banks.
template <int KS1, int NT2>
__global__ void __launch_bounds__(MMA_WARPS * 32)
seg_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ d,
                   int n, int c_in, int c_mid, int c_dec, int c_mid16) {
  constexpr int CIP = 16 * KS1 + 8;            // W1^T row stride
  const int CMP = c_mid16 + 8;                 // W2^T row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w2s = w1s + c_mid16 * CIP;
  float* b1s = reinterpret_cast<float*>(w2s + 8 * NT2 * CMP);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // Staged in the global arrays' order (coalesced reads); pad columns of
  // the smem rows are never read.
  for (int e = threadIdx.x; e < 16 * KS1 * c_mid16; e += blockDim.x) {
    const int k = e / c_mid16, j = e % c_mid16;
    w1s[j * CIP + k] =
        (j < c_mid && k < c_in) ? w1[(long)k * c_mid + j] : zero;
  }
  for (int e = threadIdx.x; e < c_mid16 * 8 * NT2; e += blockDim.x) {
    const int j = e / (8 * NT2), c = e % (8 * NT2);
    w2s[c * CMP + j] =
        (c < c_dec && j < c_mid) ? w2[(long)j * c_dec + c] : zero;
  }
  for (int j = threadIdx.x; j < c_mid16; j += blockDim.x)
    b1s[j] = j < c_mid ? b1[j] : 0.f;
  __syncthreads();

  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int warp = threadIdx.x / 32;
  const long tiles = ((long)n + 15) / 16;
  for (long tile = (long)blockIdx.x * MMA_WARPS + warp; tile < tiles;
       tile += (long)gridDim.x * MMA_WARPS) {
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

    for (int s = 0; s < c_mid16 / 16; ++s) {
      uint32_t a2[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = s * 16 + half * 8;
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* wrow = w1s + (n0 + g) * CIP + 2 * q;
#pragma unroll
        for (int kk = 0; kk < KS1; ++kk)
          mma_bf16(z, a1[kk], lds32(wrow + kk * 16), lds32(wrow + kk * 16 + 8));
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

template <int KS1, int NT2>
cudaError_t launch_seg_mma(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* d, int n,
                           int c_in, int c_mid, int c_dec, cudaStream_t s) {
  const int c_mid16 = (c_mid + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                          ((size_t)c_mid16 * (16 * KS1 + 8) +
                           (size_t)8 * NT2 * (c_mid16 + 8)) +
                      sizeof(float) * c_mid16;
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
      static_cast<__nv_bfloat16*>(d), n, c_in, c_mid, c_dec, c_mid16);
  return cudaGetLastError();
}

cudaError_t dispatch_seg_mma(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* d, int n,
                             int c_in, int c_mid, int c_dec, cudaStream_t s) {
  const bool ci32 = c_in <= 32, cd32 = c_dec <= 32;
  if (ci32 && cd32)
    return launch_seg_mma<2, 4>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  if (ci32)
    return launch_seg_mma<2, 8>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  if (cd32)
    return launch_seg_mma<4, 4>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
  return launch_seg_mma<4, 8>(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec, s);
}

// conv_fwd, bf16: an implicit GEMM on the tensor cores, M = positions, N =
// 8*NT output channels, K = 27 taps x 16*KS decay channels, over a ring of
// halo rows in shared memory.
//
// - Work items are (b, run of `run` consecutive h rows); the launcher picks
//   the run so that one wave of blocks holds the items (the whole of H, one
//   item per SM, at B >= the SM count).  A block walks down its run ROWS
//   output rows per step: rows h .. h+ROWS-1 read input rows h-1 .. h+ROWS
//   from ring slots (row hh in slot hh % (ROWS+2), a zero-padded
//   [W+2][T+2][CSP] row of d; rows outside [0, H) read one zero slot that
//   is never written), while the next step's ROWS rows of d and this step's
//   rows of x are on their way in by cp.async.  Each row of d thus crosses
//   from memory once per run, (run+2)/run times in all, and its copy
//   overlaps the products of the step before.
// - The copy: rows of d (W*T*c_dec elements each, contiguous, aligned to 2
//   bytes only) land whole in a raw buffer by 16-byte cp.async from the
//   16-byte chunk below their start; each thread then repacks 8 channels of
//   one position at a time into a slot with one 16-byte store.  Every chunk
//   read holds an element of the rows, so no read leaves their pages.  Slot
//   borders are zeroed once per block and never written again; the repack
//   writes channels c_dec..16*KS as zeros in the same 16-byte stores;
//   channels 16*KS..CSP are never read.
// - Fragments by ldmatrix.x4: one per 16-position x 16-channel A tile at a
//   tap offset, one per pair of 8-column B tiles (weights staged as [plane
//   tap][h tap][o][c]).  CSP = 16*KS + 8 makes the position stride 80 or
//   144 bytes: the 8 rows of a matrix fall in distinct banks.  The loop
//   runs over the 9 (w, t) taps and the k-steps; at each it loads the A
//   tiles of the ROWS+2 input rows and the B tiles of the 3 h taps once
//   and makes all 3*ROWS products from them, the next step's fragments
//   loading meanwhile.  Per warp and k-step at ROWS = 2: 7 KB of ldmatrix
//   for 48 mma (one row per step would take 12 KB).
// - M-tiles: a row's ceil(W*T/16) tiles are taken in passes of at most
//   RING_WARPS*RING_MT tiles; the block has just enough warps (RING_MT = 2
//   tiles each) for one pass.  At 22x9 that is 13 tiles on 7 warps: 13 of
//   14 tile slots live, 198 of 224 mma rows (88%).
// - Epilogue: the residual rows of x sit in the x/out buffer; each thread
//   adds bc and its accumulators to its own elements there, summed in
//   float32 and rounded to bf16 once, and the rows leave with 16-byte
//   stores (scalar at their two ends, or throughout where out and x differ
//   in 16-byte alignment).  Without the residual (blk_bwd's dd conv) the
//   buffer just stages the result.
// - The launcher takes the first layout that fits: ROWS = 2 (only at NT =
//   4: the accumulators of two rows at NT = 8 would spill) before 1, all
//   27 weight taps staged once per block before 3 at a time (restaged
//   inside the tap loop).
//
// Shared memory at the flagship (25 -> 32, 22x9; the dd conv's 32 -> 25 the
// same): weights 27*32*40*2 = 69,120 B, 5 slots of 24*11*40*2 = 21,120 B,
// two raw rows of d (19,840) and two of x/out (25,376): 219,936 B, one
// block of 7 warps per SM.  Shape envelope (227 KB): at these widths and
// T = 9, W <= 47, i.e. halo rows of up to 539 positions ((W+2)(T+2)),
// the fast layout up to W = 23; at 51 -> 64 (the
// 64-filter model) W <= 22, one row per step with 3 weight taps.  Beyond
// it the launch is refused with cudaErrorInvalidValue, never run.
constexpr int RING_WARPS = 8;   // most warps per block
constexpr int RING_MT = 2;      // m-tiles of 16 positions per warp and pass

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes of a raw row buffer for n bf16 elements copied from the 16-byte
// chunk below their start: at most 2n + 28, rounded up to 16.
inline int row_buf_bytes(int n) {
  return (2 * n + 43) / 16 * 16;
}

// Start the copy of row src[0, n) into buf; returns the element offset of
// src[0] in buf.
__device__ __forceinline__ int copy_row_async(__nv_bfloat16* buf,
                                              const __nv_bfloat16* src,
                                              int n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = s & ~uintptr_t(15);
  const int chunks = (int)((s + 2 * (uintptr_t)n + 15 - a) / 16);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(buf + 8 * i, a + 16 * (uintptr_t)i);
  return (int)(s - a) / 2;
}

// Element offset in a row buffer that lines its chunks up with dst's.
__device__ __forceinline__ int row_skew(const __nv_bfloat16* dst) {
  return (int)(reinterpret_cast<uintptr_t>(dst) & 15) / 2;
}

// dst[j] = buf[skew + j] for j < n; 16-byte stores where dst and buf line
// up, scalar ones at the row's ends.
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const __nv_bfloat16* buf, int skew,
                                          int n) {
  const int so = row_skew(dst);
  if (so != skew) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) dst[j] = buf[skew + j];
    return;
  }
  const int chunks = (so + n + 7) / 8;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int j0 = 8 * i - so;   // row index of the chunk's first element
    if (j0 >= 0 && j0 + 8 <= n) {
      *reinterpret_cast<uint4*>(dst + j0) =
          *reinterpret_cast<const uint4*>(buf + 8 * i);
    } else {
      for (int k = 0; k < 8; ++k)
        if (j0 + k >= 0 && j0 + k < n) dst[j0 + k] = buf[8 * i + k];
    }
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// acc[r] += the products for output rows h + r (r < ROWS) of plane taps
// pt0 .. pt0 + NPT - 1 (dw * 3 + dt) over all three h taps, for this
// warp's NM live m-tiles.  in[i] is the slot of input row h - 1 + i; input
// i feeds output r through h tap i - r, so each A fragment is loaded once
// for up to three products and each B fragment once for all ROWS rows.
// NPT * KS k-steps, unrolled, the fragments of each step loaded while the
// step before runs on the tensor cores.  wt: the staged weights
// [plane tap][h tap][o][c] plus this lane's B-row offset.
template <int KS, int NT, int ROWS, int NPT, int NM>
__device__ __forceinline__ void mma_planes(
    float (&acc)[ROWS][RING_MT][NT][4],
    const __nv_bfloat16* (&in)[ROWS + 2], const int (&aoff)[RING_MT],
    const __nv_bfloat16* wt, int pt0, int T2) {
  constexpr int CSP = 16 * KS + 8, NO = 8 * NT, NI = ROWS + 2;
  constexpr int STEPS = NPT * KS;
  if constexpr (NM > 0) {
    uint32_t a[2][NI][NM][4], b[2][3][NT / 2][4];
    auto load = [&](int s, int buf) {
      const int pt = pt0 + s / KS, kk = s % KS;
      const int toff = ((pt / 3) * T2 + pt % 3) * CSP + kk * 16;
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
                  wt + (((s / KS) * 3 + dh) * NO + jp * 16) * CSP + kk * 16);
    };
    load(0, 0);
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (s + 1 < STEPS) load(s + 1, (s + 1) % 2);
      const int cur = s % 2;
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
    }
  }
}

template <int KS, int NT, int ROWS, bool RES>
__global__ void __launch_bounds__(RING_WARPS * 32)
conv_ring_kernel(const __nv_bfloat16* __restrict__ d,
                 const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wc,
                 const float* __restrict__ bc,
                 __nv_bfloat16* __restrict__ out, int B, int H, int W,
                 int Tn, int c_dec, int c_out, int run, int wtaps,
                 int dbuf_elems) {
  constexpr int CK = 16 * KS;        // decay channels per slot position
  constexpr int CSP = CK + 8;        // channel stride of a slot position
  constexpr int NO = 8 * NT;
  constexpr int NS = ROWS + 2;       // ring slots (plus one zero slot)
  const int T2 = Tn + 2, WT = W * Tn;
  const int slot_elems = (W + 2) * T2 * CSP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* slots = ws + wtaps * NO * CSP;     // [NS + 1][W+2][T+2][CSP]
  __nv_bfloat16* dbuf = slots + (NS + 1) * slot_elems;   // raw rows of d
  __nv_bfloat16* obuf = dbuf + dbuf_elems;          // rows of x, then out
  const __nv_bfloat16* zslot = slots + NS * slot_elems;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int tid = threadIdx.x, nthr = blockDim.x;

  // wc [27][c_dec][c_out] -> ws[plane tap][h tap][o][c] for the wtaps / 3
  // plane taps from pt0 on, read in wc's order, 8 loads in flight.
  auto stage_w = [&](int pt0) {
    const int total = wtaps * CK * NO;
    for (int e0 = tid; e0 < total; e0 += 8 * nthr) {
      __nv_bfloat16 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        const int o = e % NO, rest = e / NO;
        const int c = rest % CK, lt = rest / CK;
        const int tap = (lt % 3) * 9 + pt0 + lt / 3;
        v[k] = (e < total && c < c_dec && o < c_out)
                   ? wc[((long)tap * c_dec + c) * c_out + o] : zero;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * nthr;
        const int o = e % NO, rest = e / NO;
        if (e < total) ws[((rest / CK) * NO + o) * CSP + rest % CK] = v[k];
      }
    }
  };
  // Raw row of d at element `src` of dbuf -> interior of row hh's slot,
  // channels 0..CK (zero from c_dec), 8 channels of a position per step.
  auto repack = [&](int hh, int src) {
    __nv_bfloat16* slot = slots + (hh % NS) * slot_elems;
    for (int u = tid; u < WT * 2 * KS; u += nthr) {
      const int p = u / (2 * KS), j = u % (2 * KS);
      const int w = p / Tn, t = p - w * Tn;
      const __nv_bfloat16* s = dbuf + src + p * c_dec + 8 * j;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 8 * j + 2 * k;
        v[k] = pack2(c < c_dec ? s[2 * k] : zero,
                     c + 1 < c_dec ? s[2 * k + 1] : zero);
      }
      *reinterpret_cast<uint4*>(slot + ((w + 1) * T2 + t + 1) * CSP + 8 * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  // Rows r0 .. r0 + n - 1 (n <= ROWS) of d: copy, wait, repack.
  auto load_rows = [&](long brow, int r0, int n) {
    const int skew = copy_row_async(dbuf, d + (brow + r0) * WT * c_dec,
                                    n * WT * c_dec);
    cp_async_wait_all();
    __syncthreads();
    for (int r = 0; r < n; ++r) repack(r0 + r, skew + r * WT * c_dec);
    __syncthreads();
  };

  for (int e = tid; e < (NS + 1) * slot_elems / 8; e += nthr)
    reinterpret_cast<uint4*>(slots)[e] = make_uint4(0, 0, 0, 0);
  if (wtaps == 27) stage_w(0);   // visible after the first row's barrier

  const int lane = tid % 32, warp = tid / 32, nw = nthr / 32;
  const int g = lane / 4, q = lane % 4;
  // This lane's ldmatrix row of the B tiles: o = 8 * (lane / 16) + lane % 8,
  // channels 8 * ((lane / 8) % 2) on.
  const int boff = (8 * (lane / 16) + lane % 8) * CSP + 8 * ((lane / 8) % 2);
  float bcv[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int o = t * 8 + 2 * q + k;
      bcv[t][k] = (RES && o < c_out) ? bc[o] : 0.f;
    }

  const int tiles = (WT + 15) / 16;
  const int runs = (H + run - 1) / run;
  const long items = (long)B * runs;
  for (long item = blockIdx.x; item < items; item += gridDim.x) {
    const long brow = (item / runs) * H;            // b * H
    const int h0 = (int)(item % runs) * run;
    const int h1 = min(H, h0 + run);
    const int top = min(H - 1, h1);                 // last input row
    for (int r = max(0, h0 - 1); r <= min(top, h0 + ROWS); r += ROWS)
      load_rows(brow, r, min(ROWS, min(top, h0 + ROWS) - r + 1));

    for (int h = h0; h < h1; h += ROWS) {
      // Output rows h .. h + nout - 1; rows past h1 (an odd run's last
      // step) are computed from whatever their slots hold and not stored.
      const int nout = min(ROWS, h1 - h);
      const int nlo = h + ROWS + 1;                 // the next step's rows
      const int nn = max(0, min(top, h + 2 * ROWS) - nlo + 1);
      const int dskew = nn > 0 ? copy_row_async(
          dbuf, d + (brow + nlo) * WT * c_dec, nn * WT * c_dec) : 0;
      const long orow = (brow + h) * WT * c_out;
      const int oskew = RES ? copy_row_async(obuf, x + orow,
                                             nout * WT * c_out)
                            : row_skew(out + orow);
      cp_async_commit();
      const __nv_bfloat16* in[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int hh = h - 1 + i;
        in[i] = (hh >= 0 && hh < H) ? slots + (hh % NS) * slot_elems : zslot;
      }

      for (int t0 = 0; t0 < tiles; t0 += nw * RING_MT) {
        int aoff[RING_MT];
        bool live[RING_MT];
        float acc[ROWS][RING_MT][NT][4];
#pragma unroll
        for (int m = 0; m < RING_MT; ++m) {
          const int tm = t0 + warp * RING_MT + m;
          live[m] = tm < tiles;
          // ldmatrix row of the A tile: position 16 tm + lane % 16,
          // channels 8 * (lane / 16) on; past the row, position 0 (its
          // results are never stored).
          int p = tm * 16 + lane % 16;
          if (p >= WT) p = 0;
          aoff[m] = ((p / Tn) * T2 + p % Tn) * CSP + 8 * (lane / 16);
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
          if (wtaps == 27) {
            mma_planes<KS, NT, ROWS, 9, NM>(acc, in, aoff, ws + boff, 0, T2);
            return;
          }
          for (int pt = 0; pt < 9; ++pt) {   // one plane tap's 3 h taps
            __syncthreads();
            stage_w(pt);
            __syncthreads();
            mma_planes<KS, NT, ROWS, 1, NM>(acc, in, aoff, ws + boff, pt, T2);
          }
        };
        const int nlive = tiles - t0 - warp * RING_MT;
        if (nlive >= RING_MT)
          taps(std::integral_constant<int, RING_MT>());
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
          for (int m = 0; m < RING_MT; ++m) {
            if (!live[m]) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int p =
                  (t0 + warp * RING_MT + m) * 16 + g + (i < 2 ? 0 : 8);
              if (p >= WT) continue;
#pragma unroll
              for (int t = 0; t < NT; ++t) {
                const int o = t * 8 + 2 * q + (i & 1);
                if (o >= c_out) continue;
                __nv_bfloat16& e =
                    obuf[oskew + (r * WT + p) * c_out + o];
                const float v = acc[r][m][t][i];
                e = __float2bfloat16_rn(
                    RES ? v + bcv[t][i & 1] + __bfloat162float(e) : v);
              }
            }
          }
        }
      }

      __syncthreads();   // the step's slots read, its out rows staged
      for (int r = 0; r < nn; ++r) repack(nlo + r, dskew + r * WT * c_dec);
      store_row(out + orow, obuf, oskew, nout * WT * c_out);
      __syncthreads();   // dbuf and obuf free for the next step's copies
    }
  }
}

// Shared-memory bytes of conv_ring_kernel<KS, NT, ROWS> with `wtaps`
// weight taps staged.
template <int KS, int NT, int ROWS>
size_t ring_smem(int W, int Tn, int c_dec, int c_out, int wtaps) {
  constexpr int CSP = 16 * KS + 8;
  const int WT = W * Tn;
  return 2 * ((size_t)wtaps * 8 * NT * CSP +
              (size_t)(ROWS + 3) * (W + 2) * (Tn + 2) * CSP) +
         row_buf_bytes(ROWS * WT * c_dec) + row_buf_bytes(ROWS * WT * c_out);
}

template <int KS, int NT, int ROWS, bool RES>
cudaError_t launch_conv_ring(const void* d, const void* x, const void* wc,
                             const void* bc, void* out, int B, int H, int W,
                             int Tn, int c_dec, int c_out, int wtaps,
                             cudaStream_t s) {
  const int WT = W * Tn;
  const int tiles = (WT + 15) / 16;
  const int per_pass = RING_WARPS * RING_MT;
  const int passes = (tiles + per_pass - 1) / per_pass;
  const int warps = (tiles + passes * RING_MT - 1) / (passes * RING_MT);
  const size_t smem = ring_smem<KS, NT, ROWS>(W, Tn, c_dec, c_out, wtaps);
  auto kern = conv_ring_kernel<KS, NT, ROWS, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  const long resident = (long)(per_sm > 0 ? per_sm : 1) * sm_count();
  // Run length: the least work for the busiest wave of blocks, counting a
  // row's products twice (steps of ROWS rows) and its copy once.
  int run = H;
  long best = -1;
  for (int r = H; r >= 1; --r) {
    const long items = (long)B * ((H + r - 1) / r);
    const long steps = (r + ROWS - 1) / ROWS;
    const long cost = (items + resident - 1) / resident *
                      (2 * ROWS * steps + r + 2);
    if (best < 0 || cost < best) best = cost, run = r;
  }
  const long items = (long)B * ((H + run - 1) / run);
  const int grid = (int)(items < resident ? items : resident);
  kern<<<grid, warps * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wc), static_cast<const float*>(bc),
      static_cast<__nv_bfloat16*>(out), B, H, W, Tn, c_dec, c_out, run, wtaps,
      row_buf_bytes(ROWS * WT * c_dec) / 2);
  return cudaGetLastError();
}

// The first layout that fits the card's shared memory: two output rows
// per step where the accumulators allow (NT = 4), else one; all 27 weight
// taps staged once, else 3 at a time.  None: cudaErrorInvalidValue.
template <int KS, int NT, bool RES>
cudaError_t pick_conv_ring(const void* d, const void* x, const void* wc,
                           const void* bc, void* out, int B, int H, int W,
                           int Tn, int c_dec, int c_out, cudaStream_t s) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t cap = (size_t)optin;
  const int choices[2] = {27, 3};
  for (int wtaps : choices) {
    if constexpr (NT == 4) {
      if (ring_smem<KS, NT, 2>(W, Tn, c_dec, c_out, wtaps) <= cap)
        return launch_conv_ring<KS, NT, 2, RES>(d, x, wc, bc, out, B, H, W,
                                                Tn, c_dec, c_out, wtaps, s);
    }
    if (ring_smem<KS, NT, 1>(W, Tn, c_dec, c_out, wtaps) <= cap)
      return launch_conv_ring<KS, NT, 1, RES>(d, x, wc, bc, out, B, H, W, Tn,
                                              c_dec, c_out, wtaps, s);
  }
  return cudaErrorInvalidValue;   // outside the envelope
}

template <bool RES>
cudaError_t dispatch_conv_mma(const void* d, const void* x, const void* wc,
                              const void* bc, void* out, int B, int H, int W,
                              int Tn, int c_dec, int c_out, cudaStream_t s) {
  if (c_dec > 64 || c_out > 64) return cudaErrorInvalidValue;
  const bool cd32 = c_dec <= 32, co32 = c_out <= 32;
  if (cd32 && co32)
    return pick_conv_ring<2, 4, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                     c_out, s);
  if (cd32)
    return pick_conv_ring<2, 8, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                     c_out, s);
  if (co32)
    return pick_conv_ring<4, 4, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                     c_out, s);
  return pick_conv_ring<4, 8, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                   c_out, s);
}

}  // namespace

cudaError_t probav::conv_dispatch(int dtype, bool residual, const void* d,
                                  const void* x, const void* wc,
                                  const void* bc, void* out, int B, int H,
                                  int W, int Tn, int c_dec, int c_out,
                                  cudaStream_t s) {
  if (dtype == 0)
    return residual ? dispatch_conv<true>(d, x, wc, bc, out, B, H, W, Tn,
                                          c_dec, c_out, s)
                    : dispatch_conv<false>(d, x, wc, bc, out, B, H, W, Tn,
                                           c_dec, c_out, s);
  if (dtype == 1)
    return residual ? dispatch_conv_mma<true>(d, x, wc, bc, out, B, H, W, Tn,
                                              c_dec, c_out, s)
                    : dispatch_conv_mma<false>(d, x, wc, bc, out, B, H, W, Tn,
                                               c_dec, c_out, s);
  return cudaErrorInvalidValue;
}

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  x, w1, w2,
// d in that dtype; b1, b2 in float32.  c_in, c_dec up to 64; c_mid any
// positive count that fits shared memory.
int probav_seg_fwd(int dtype, const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* d, int n, int c_in,
                   int c_mid, int c_dec, void* stream) {
  if (n < 0 || c_in < 1 || c_in > 64 || c_dec < 1 || c_dec > 64 || c_mid < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_seg(x, w1, b1, w2, b2, d, n, c_in, c_mid,
                                    c_dec, s);
  if (dtype == 1)
    return (int)dispatch_seg_mma(x, w1, b1, w2, b2, d, n, c_in, c_mid, c_dec,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above.  d, x, wc, out in that dtype; bc in float32.
// wc is [3, 3, 3, c_dec, c_out] (taps over H, W, T), c_dec and c_out up
// to 64.  bf16 also refuses a volume whose halo-row ring does not fit
// shared memory (see conv_ring_kernel).
int probav_conv_fwd(int dtype, const void* d, const void* x, const void* wc,
                    const void* bc, void* out, int B, int H, int W, int Tn,
                    int c_dec, int c_out, void* stream) {
  if (B < 0 || H < 1 || W < 1 || Tn < 1 || c_dec < 1 || c_dec > 64 ||
      c_out < 1 || c_out > 64)
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
