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
// the conv's ragged (H, W, T) edges are bounds checks while the halo is
// staged.
//
// What bounds them on an H100: seg_fwd is 2*(C_in*C_mid + C_mid*C_dec)
// FLOP per row (29,184 at the flagship's 32/256/25) and conv_fwd
// 2*27*C_dec*C_out per position (43,200 at 25->32), against a few dozen
// elements of traffic per row, so both are compute-bound once the
// [N, C_mid] wide activation never reaches device memory -- the point of
// the TPU kernel, kept here in both versions:
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
//   registers, conv_fwd is an implicit GEMM over the 27 taps of a staged
//   halo (see the section below).
//
// Both round where the TPU kernels round: sums in float32, the relu output
// cast to the compute dtype before the decay product, outputs stored in
// the compute dtype.  wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes (probav_tpu_torch/ops/_build.py):
// every entry point launches on the given stream and returns
// cudaGetLastError() (or the error of the call that failed first).

#include "common.cuh"

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
constexpr int CONV_WARPS = 8;    // warps per block of conv_fwd_mma_kernel

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

// conv_fwd, bf16: implicit GEMM, M = positions, N = 8*NT output channels,
// K = 27 taps x 16*KS decay channels.  Blocks walk over (b, h, position
// chunk) items.  For each h tap a block stages the zero-padded halo row of
// d ([W+2][T+2][16*KS+8], bf16) in shared memory; the taps' weights,
// transposed to [tap][o][c], are staged once per block, or with each h tap
// (PER_DH) where all 27 would not fit (64/64 channels).  Each warp owns up
// to MT m-tiles of 16 positions and keeps their accumulators in registers
// across all taps.
template <int KS, int NT, bool PER_DH, bool RES>
__global__ void __launch_bounds__(CONV_WARPS * 32)
conv_fwd_mma_kernel(const __nv_bfloat16* __restrict__ d,
                    const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wc,
                    const float* __restrict__ bc,
                    __nv_bfloat16* __restrict__ out, int B, int H, int W,
                    int Tn, int c_dec, int c_out) {
  constexpr int CSP = 16 * KS + 8;               // channel stride (padded)
  constexpr int MT = CONV_POS / 16 / CONV_WARPS;  // m-tiles per warp
  constexpr int NO = 8 * NT;
  constexpr int WTAPS = PER_DH ? 9 : 27;         // taps held in smem
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* halo = ws + WTAPS * NO * CSP;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int W2 = W + 2, T2 = Tn + 2, WT = W * Tn;

  // wc [27][c_dec][c_out] -> ws[tap][o][c], read in wc's order.
  auto stage_w = [&](int tap0) {
    for (int e = threadIdx.x; e < WTAPS * 16 * KS * NO; e += blockDim.x) {
      const int o = e % NO, rest = e / NO;
      const int c = rest % (16 * KS), tap = rest / (16 * KS);
      ws[(tap * NO + o) * CSP + c] =
          (c < c_dec && o < c_out)
              ? wc[((long)(tap0 + tap) * c_dec + c) * c_out + o] : zero;
    }
  };
  if (!PER_DH) stage_w(0);

  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int warp = threadIdx.x / 32;
  const int chunks = (WT + CONV_POS - 1) / CONV_POS;
  const long items = (long)B * H * chunks;
  for (long item = blockIdx.x; item < items; item += gridDim.x) {
    const int chunk = (int)(item % chunks);
    const long bh = item / chunks;
    const int h = (int)(bh % H);
    const int p0 = chunk * CONV_POS;
    const int live_tiles = (WT - p0 + 15) / 16 - warp * MT;   // may be <= 0

    // Halo offset of each of this lane's rows (g and g+8 of every m-tile);
    // positions past the volume read position 0 and are never stored.
    int base[MT][2];
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int p = p0 + (warp * MT + m) * 16 + g + 8 * r;
        if (p >= WT) p = 0;
        base[m][r] = ((p / Tn) * T2 + p % Tn) * CSP + 2 * q;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
        acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.f;
    }

    for (int dh = 0; dh < 3; ++dh) {
      const int hh = h + dh - 1;
      __syncthreads();   // previous halo row (and weights) consumed
      if (PER_DH) stage_w(dh * 9);
      // One padded position per warp step, lanes over its channels.
      const bool row_in = hh >= 0 && hh < H;
      for (int pos = warp; pos < W2 * T2; pos += CONV_WARPS) {
        const int wi = pos / T2, ti = pos % T2;
        const bool in = row_in && wi >= 1 && wi <= W && ti >= 1 && ti <= Tn;
        const __nv_bfloat16* src =
            d + (((bh + dh - 1) * W + (wi - 1)) * (long)Tn + (ti - 1)) * c_dec;
        for (int c = lane; c < CSP; c += 32)
          halo[pos * CSP + c] = (in && c < c_dec) ? src[c] : zero;
      }
      __syncthreads();
      if (!row_in) continue;   // zero row: contributes nothing

      for (int tap9 = 0; tap9 < 9; ++tap9) {
        const int dw = tap9 / 3, dt = tap9 % 3;
        const int toff = (dw * T2 + dt) * CSP;
        const __nv_bfloat16* wt =
            ws + (PER_DH ? tap9 : dh * 9 + tap9) * NO * CSP;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const __nv_bfloat16* r0p = halo + base[m][0] + toff + kk * 16;
            const __nv_bfloat16* r1p = halo + base[m][1] + toff + kk * 16;
            a[m][0] = lds32(r0p);
            a[m][1] = lds32(r1p);
            a[m][2] = lds32(r0p + 8);
            a[m][3] = lds32(r1p + 8);
          }
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const __nv_bfloat16* wrow = wt + (t * 8 + g) * CSP + kk * 16 + 2 * q;
            const uint32_t b0 = lds32(wrow), b1 = lds32(wrow + 8);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              if (m < live_tiles) mma_bf16(acc[m][t], a[m], b0, b1);
          }
        }
      }
    }

    // out = acc + bc + x (RES) or acc, summed in float32, stored in bf16.
    const long row0 = bh * WT;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + (warp * MT + m) * 16 + g + (i < 2 ? 0 : 8);
        if (p >= WT) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int o = t * 8 + 2 * q + (i & 1);
          if (o < c_out) {
            const long idx = (row0 + p) * c_out + o;
            out[idx] = __float2bfloat16_rn(
                RES ? acc[m][t][i] + bc[o] + __bfloat162float(x[idx])
                    : acc[m][t][i]);
          }
        }
      }
    }
  }
}

template <int KS, int NT, bool RES>
cudaError_t launch_conv_mma(const void* d, const void* x, const void* wc,
                            const void* bc, void* out, int B, int H, int W,
                            int Tn, int c_dec, int c_out, cudaStream_t s) {
  constexpr int CSP = 16 * KS + 8;
  constexpr bool PER_DH = KS * NT > 16;   // all 27 taps fit but at 64/64
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(PER_DH ? 9 : 27) * 8 * NT * CSP +
                       (size_t)(W + 2) * (Tn + 2) * CSP);
  auto kern = conv_fwd_mma_kernel<KS, NT, PER_DH, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long items = (long)B * H * ((W * Tn + CONV_POS - 1) / CONV_POS);
  const long cap = 4L * sm_count();
  const int grid = (int)(items < cap ? items : cap);
  kern<<<grid, CONV_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wc), static_cast<const float*>(bc),
      static_cast<__nv_bfloat16*>(out), B, H, W, Tn, c_dec, c_out);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t dispatch_conv_mma(const void* d, const void* x, const void* wc,
                              const void* bc, void* out, int B, int H, int W,
                              int Tn, int c_dec, int c_out, cudaStream_t s) {
  const bool cd32 = c_dec <= 32, co32 = c_out <= 32;
  if (cd32 && co32)
    return launch_conv_mma<2, 4, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                      c_out, s);
  if (cd32)
    return launch_conv_mma<2, 8, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                      c_out, s);
  if (co32)
    return launch_conv_mma<4, 4, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
                                      c_out, s);
  return launch_conv_mma<4, 8, RES>(d, x, wc, bc, out, B, H, W, Tn, c_dec,
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
// wc is [3, 3, 3, c_dec, c_out] (taps over H, W, T), c_out up to 64.
int probav_conv_fwd(int dtype, const void* d, const void* x, const void* wc,
                    const void* bc, void* out, int B, int H, int W, int Tn,
                    int c_dec, int c_out, void* stream) {
  if (B < 0 || H < 1 || W < 1 || Tn < 1 || c_dec < 1 || c_out < 1 ||
      c_out > 64)
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
