// Hand-written Hopper kernels for the backward of one WDSR-B block.
//
// Replaces the TPU kernel blk_bwd (probav_tpu/ops/pallas_tstack.py:388,
// body _blk_bwd_kernel :327), which computes in one pass, for the block
// out = x + bc + conv3d_SAME(d, wc), d = W2^T relu(W1^T x + b1) + b2:
//
//   dd  = conv-transpose of gy over the 27 taps        [N, c_dec]
//   dWc = sum_q d(q + tap) gy(q)^T,  dbc = sum_q gy(q)
//   z   = W1^T x + b1 (recomputed), dz = relu'(z) * (W2 dd)
//   dx  = W1 dz + gy
//   dW1 = sum x dz^T, dW2 = sum relu(z) dd^T, db1 = sum dz, db2 = sum dd
//
// Activations stay in the model's channels-last [B, H, W, T, C] layout, so
// a block is [N, C] rows; the TPU kernel's [C, ext] lane layout, interior
// mask and halo margins are not ported.  One entry point, probav_blk_bwd,
// launches four kernels on the caller's stream:
//
//   1. dd: the 3^3 SAME conv of tstack.cu without bias or residual, fed gy
//      and the taps flipped with their channel axes swapped (the wrapper
//      prepares them, as pallas_tstack._pack_wc_bwd does).  It runs on the
//      tensor cores at both dtypes (float32 as 3xTF32).  dd is rounded to
//      the working dtype and makes one
//      round trip through device memory (2 * N * c_dec elements, 56 MB at
//      bf16 on the flagship train step), where the TPU kernel keeps it in
//      VMEM: one kernel cannot hold the conv halo, the 27-tap weights and
//      the expand/decay weights and partials together.
//   2. wgrad: dWc, a sum over positions of d (shifted by the tap) times gy.
//   3. seg_bwd: everything else: z recomputed, dz, dx, dW1, dW2 and the
//      bias grads.  The wide z / dz [N, c_mid] never reach device memory.
//   4. reduce: out[i] = sum over g of part[g][i], the weight-gradient
//      partials of kernels 2 and 3 summed across their blocks (the JAX
//      package sums its per-tile partials in XLA after its kernel,
//      pallas_tstack.py:445-449); reduce_partials_kernel, below.
//
// Kernels 2 and 3 come in several versions, chosen from the dtype and the
// widths before any launch.  At c_in, c_dec <= 32 and c_mid <= 256 (the
// flagship's 32/256/25) seg_bwd runs on the tensor cores at both dtypes
// (seg_bwd_route): bf16 as seg_bwd_bf16_kernel (mma.sync m16n8k16, float32
// sums, products taken transposed so that each C fragment feeds the next
// product in registers, fragments by ldmatrix from channels-last tiles
// staged by cp.async), float32 as seg_bwd_tf32_kernel (3xTF32 on mma.sync
// m16n8k8); so does the wgrad where its rows fit shared memory
// (wgrad_route: bf16 wgrad_ring_kernel, ldmatrix.trans on channels-last
// halo rows staged by cp.async; float32 wgrad_tf32_kernel, 3xTF32 on halo
// rows copied straight into a ring of four slots).  Both also run on the
// tensor cores up to c_in, c_dec <= 64 at both dtypes (the 64-filter
// model's 64/512/51, the 48-filter model's 48/384/38): seg_bwd, to c_mid
// <= 512, with c_mid cut into chunks over the grid, each block writing its
// chunk's float32 part of dx, then dx_sum_kernel, which sums the parts and
// gy (dx rounded once): bf16 as seg_bwd_split_kernel (chunks of 256),
// float32 as seg_bwd_tf32_split_kernel (3xTF32, chunks of 128); the wgrad
// in 32 x 32 channel tiles over the grid, bf16 as wgrad_tiles_kernel,
// staged by producer warps of their own, float32 as
// wgrad_tf32_tiles_kernel, wgrad_tf32_kernel's layout a tile.  Beyond 64
// channels (up to 128/1024/102) and the wgrad on larger rows run on the
// CUDA cores (wgrad_kernel, seg_bwd_kernel: bf16 data widened to float32,
// whose products of bf16 values are exact), so every width from 1 to
// MAX_CH = 128 channels has a kernel.
//
// Reductions across blocks: kernels 2 and 3 run a persistent grid of G
// blocks; each block owns one float32 slot of the partial buffer and sums
// into it over all its tiles, in registers written once at the end (the
// wgrad kernels, seg_bwd_bf16, seg_bwd_tf32) or in the slot itself
// (seg_bwd), with no atomics.  The channel-tiled wgrads and the split
// seg_bwds run a few blocks a slot (its tiles, its chunks of c_mid, then
// the dx sum for dbc), each writing a disjoint part of it, so every entry
// still has one writer.  Slots lie `stride` floats apart, a
// multiple of 32 at least the slot's length (128-byte aligned rows, so the
// reduce reads them as float4).  Kernel 4 sums the G slots in a fixed
// order with no atomics, so a run is deterministic, as the per-tile
// partials of pallas_tstack.py:445-449 are.
//
// What bounds it on an H100: per row 2 * 27 * c_dec * c_out FLOP each for
// dd and dWc, and 2 * c_mid * (3 c_in + 2 c_dec) for the z recompute, W2 dd,
// W1 dz, dW1 and dW2: in all 161,152 FLOP per row at the flagship
// 32/256/25 (89.9 GFLOP per launch at N = 557,568) against ~89 elements
// read and 32 written per row: compute-bound,
// 91 us at the 989 TFLOP/s bf16 peak; float32 0.545 ms as 3xTF32 at the
// 494.7 TFLOP/s TF32 peak (1.34 ms at the CUDA cores' 67 TFLOP/s).  This
// version keeps the wide activation out of device memory and the dd conv,
// seg_bwd and the wgrad on the tensor cores at the flagship's widths; all
// four of them pipeline their staging (cp.async), and all use mma.sync,
// not wgmma, which is later work.
//
// Rounding points (pallas_tstack.py:356-379): dd summed in float32 then
// rounded; dz from float32 W2 dd, masked by z > 0 on the float32 z, then
// rounded; h = relu(z) rounded; dx = W1 dz + gy in float32, stored in the
// working dtype; all weight partials float32.
//
// A second entry point, probav_wide_bwd, replaces the TPU kernel _bwd of
// probav_tpu/ops/pallas_wide_block.py:110 (body _bwd_kernel :78): the
// backward of the flat [N, C] expand -> relu -> decay segment alone, for
// `--fused-stack flat` and WDSRBlock(fused=True).  Given x, W1, b1, W2 and
// dy it recomputes z and returns dx = W1 dz (no residual) and dW1, db1,
// dW2, db2 (db2 = sum dy), with dz and relu(z) kept float32 as in
// _bwd_kernel, into per-block partial slots (in a layout without dWc and
// dbc) and the same fixed-order reduce.  The TPU row tiling (_pick_tile,
// _pad_rows) is a VMEM rule and is not ported: any N is taken.  Three
// kernels, chosen from the dtype and widths before any launch
// (wide_bwd_route).  At c_in, c_dec <= 32 and c_mid <= 256 (the flagship's
// 32/256/25) both dtypes run on the tensor cores: bf16 as
// wide_bwd_bf16_kernel, the layout of seg_bwd_bf16_kernel with dz and
// relu(z) split three ways into bf16 pieces where they meet a product, so
// that nothing is rounded to bf16 but dx; float32 as wide_bwd_tf32_kernel,
// the WIDE flavour of seg_bwd_tf32_kernel (3xTF32).  Beyond, at both
// dtypes (the 64-filter model's 64/512/51 included: seg_bwd_split_kernel's
// chunks are blk_bwd's alone), seg_bwd_kernel with WIDE set on the CUDA
// cores.  Bound on an H100 at the flagship N =
// 557,568, 32/256/25: 2 N c_mid (3 c_in + 2 c_dec) = 41.7 GFLOP against
// ~89 elements per row moved, so operations: float32 0.253 ms as 3xTF32
// (0.62 ms at the CUDA-core peak); bf16 0.094 ms, counting z and W2 dy
// once and dx, dW1 and dW2 (one float32 operand each) three times at the
// bf16 peak.

#include "common.cuh"

#include <algorithm>
#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;
using probav::copy_rows;
using probav::FragA;
using probav::FragB;
using probav::from_f;
using probav::mma_term;
using probav::round_to;
using probav::split_a;
using probav::split_b;
using probav::to_f;

constexpr int BWD_ROWS = 128;   // rows per seg_bwd tile = threads per block
constexpr int BWD_MCH = 32;     // middle channels per seg_bwd chunk
constexpr int BWD_MS = BWD_MCH + 1;   // dz / h tile row stride (odd)
constexpr int WG_THREADS = 256;       // wgrad threads per block

// Layout of one partial slot (floats), also the layout of the reduced
// output: dWc [27][c_dec][c_out] | dW1 [c_in][c_mid] | dW2 [c_mid][c_dec]
// | db1 [c_mid] | db2 [c_dec] | dbc [c_in].  Without `conv` (the wide
// block's backward) there is no dWc and no dbc.
struct Slot {
  long w1, w2, b1, b2, bc, len;   // dWc starts at 0
  __host__ __device__ Slot(int c_in, int c_mid, int c_dec, bool conv = true) {
    w1 = conv ? 27L * c_dec * c_in : 0;
    w2 = w1 + (long)c_in * c_mid;
    b1 = w2 + (long)c_mid * c_dec;
    b2 = b1 + c_mid;
    bc = b2 + c_dec;
    len = bc + (conv ? c_in : 0);
  }
};

// ------------------------------------------------------------------------ //
// wgrad: dWc[tap][c][o] = sum_q d[q + off(tap)][c] * gy[q][o]                //
// A block owns one h tap (blockIdx.y) and one tile of 32*CDB c's by 8*COB   //
// o's (blockIdx.z; one tile up to the flagship's and the 64-filter         //
// model's widths); each thread CDB c's (stride 32) and COB o's per tap.    //
// Work items are (b, h, run of wcols columns): whole rows where the run's   //
// gy and its d halo fit shared memory (every width at W = 22, T = 9),     //
// else runs of columns (at W = 48 from c_dec = 64 on).                    //
// ------------------------------------------------------------------------ //

template <typename T, int CDB, int COB>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const T* __restrict__ d, const T* __restrict__ gy,
             float* __restrict__ part, long slot_len, int B, int H, int W,
             int Tn, int c_dec, int c_out, int wcols) {
  constexpr int COP = COB * 8;           // gy row stride in smem, o's a tile
  constexpr int CT = CDB * 32;           // c's a tile
  extern __shared__ __align__(16) float smem[];
  const int ctiles = (c_dec + CT - 1) / CT;
  const int c0 = (int)(blockIdx.z % ctiles) * CT;
  const int o0 = (int)(blockIdx.z / ctiles) * COP;
  const int cw = min(CT, c_dec - c0);    // this tile's c's
  const int hs = cw | 1;                 // odd halo channel stride
  const int T2 = Tn + 2;
  const int wruns = (W + wcols - 1) / wcols;
  float* gys = smem;                     // [wcols * Tn][COP]
  float* halo = gys + wcols * Tn * COP;  // [wcols + 2][T2][hs]

  const int tid = threadIdx.x;
  const int oq = tid % 8, cg = tid / 8;  // o's oq*COB.., c's cg + 32 i
  const int dh = blockIdx.y;
  int cidx[CDB];
#pragma unroll
  for (int i = 0; i < CDB; ++i) {
    const int c = cg + 32 * i;
    cidx[i] = c < cw ? c : cw - 1;       // clamp: never stored
  }
  float acc[9][CDB][COB];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < CDB; ++i)
#pragma unroll
      for (int u = 0; u < COB; ++u) acc[t][i][u] = 0.f;

  for (long item = blockIdx.x; item < (long)B * H * wruns;
       item += gridDim.x) {
    const long row = item / wruns;       // b * H + h
    const int w0 = (int)(item % wruns) * wcols, wl = min(wcols, W - w0);
    const int h = (int)(row % H);
    const int hh = h + dh - 1;
    if (hh < 0 || hh >= H) continue;     // uniform over the block
    __syncthreads();                     // previous item fully consumed
    // Row bases once, int offsets within a row: a 64-bit index per element
    // makes the compiler branch around each load, one in flight a thread
    // (17% of the flagship's wgrad time).
    const T* gsrc = gy + ((row * W + w0) * Tn * c_out + o0);
    for (int e = tid; e < wl * Tn * COP; e += WG_THREADS) {
      const int p = e / COP, o = e % COP;
      gys[e] = o0 + o < c_out ? to_f(gsrc[p * c_out + o]) : 0.f;
    }
    const T* dsrc = d + ((row + dh - 1) * W * Tn * c_dec + c0);
    const int halo_floats = (wl + 2) * T2 * hs;
    for (int e = tid; e < halo_floats; e += WG_THREADS) {
      const int c = e % hs, wt = e / hs;
      const int ti = wt % T2, w = w0 - 1 + wt / T2;
      float v = 0.f;
      if (c < cw && w >= 0 && w < W && ti >= 1 && ti <= Tn)
        v = to_f(dsrc[(w * Tn + ti - 1) * c_dec + c]);
      halo[e] = v;
    }
    __syncthreads();

    int pw = 0, pt = 0;
    for (int p = 0; p < wl * Tn; ++p) {
      float gv[COB];
      const float4* g4 = reinterpret_cast<const float4*>(gys + p * COP +
                                                         oq * COB);
#pragma unroll
      for (int u = 0; u < COB / 4; ++u) {
        const float4 v = g4[u];
        gv[4 * u] = v.x; gv[4 * u + 1] = v.y;
        gv[4 * u + 2] = v.z; gv[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dw = t / 3, dt = t % 3;
        const float* dv = halo + ((pw + dw) * T2 + pt + dt) * hs;
#pragma unroll
        for (int i = 0; i < CDB; ++i) {
          const float v = dv[cidx[i]];
#pragma unroll
          for (int u = 0; u < COB; ++u)
            acc[t][i][u] = fmaf(v, gv[u], acc[t][i][u]);
        }
      }
      if (++pt == Tn) { pt = 0; ++pw; }
    }
  }

  float* out = part + blockIdx.x * slot_len;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < CDB; ++i) {
      const int c = cg + 32 * i;
      if (c >= cw) continue;
#pragma unroll
      for (int u = 0; u < COB; ++u) {
        const int o = o0 + oq * COB + u;
        if (o < c_out)
          out[((long)(dh * 9 + t) * c_dec + c0 + c) * c_out + o] =
              acc[t][i][u];
      }
    }
}

template <typename T, int CDB, int COB>
size_t wgrad_smem(int wcols, int Tn, int c_dec) {
  const int hs = std::min(CDB * 32, c_dec) | 1;
  return sizeof(float) * ((size_t)wcols * Tn * COB * 8 +
                          (size_t)(wcols + 2) * (Tn + 2) * hs);
}

template <typename T, int CDB, int COB>
cudaError_t launch_wgrad(const void* d, const void* gy, float* part,
                         long slot_len, int G, int B, int H, int W, int Tn,
                         int c_dec, int c_out, cudaStream_t s) {
  // Whole rows where they fit, else the widest run of columns that does,
  // the runs of a row made equal to within a column; refused before any
  // launch where not even one column fits (T > 222 at 64 x 64 tiles).
  const size_t optin = (size_t)probav::optin_smem();
  int wcols = W;
  while (wcols > 0 && wgrad_smem<T, CDB, COB>(wcols, Tn, c_dec) > optin)
    --wcols;
  if (wcols < 1) return cudaErrorInvalidValue;
  const int runs = (W + wcols - 1) / wcols;
  wcols = (W + runs - 1) / runs;
  const size_t smem = wgrad_smem<T, CDB, COB>(wcols, Tn, c_dec);
  auto kern = wgrad_kernel<T, CDB, COB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (c_dec + CDB * 32 - 1) / (CDB * 32) *
                    ((c_out + COB * 8 - 1) / (COB * 8));
  kern<<<dim3(G, 3, tiles), WG_THREADS, smem, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(gy), part, slot_len, B,
      H, W, Tn, c_dec, c_out, wcols);
  return cudaGetLastError();
}

// Tiles of up to 64 c's by 64 o's (beyond that, more tiles: the per-thread
// sums, 9 x CDB x COB, stay at most 144).
template <typename T>
cudaError_t dispatch_wgrad(const void* d, const void* gy, float* part,
                           long slot_len, int G, int B, int H, int W, int Tn,
                           int c_dec, int c_out, cudaStream_t s) {
  const bool cd32 = c_dec <= 32, co32 = c_out <= 32;
  if (cd32 && co32)
    return launch_wgrad<T, 1, 4>(d, gy, part, slot_len, G, B, H, W, Tn, c_dec,
                                 c_out, s);
  if (cd32)
    return launch_wgrad<T, 1, 8>(d, gy, part, slot_len, G, B, H, W, Tn, c_dec,
                                 c_out, s);
  if (co32)
    return launch_wgrad<T, 2, 4>(d, gy, part, slot_len, G, B, H, W, Tn, c_dec,
                                 c_out, s);
  return launch_wgrad<T, 2, 8>(d, gy, part, slot_len, G, B, H, W, Tn, c_dec,
                               c_out, s);
}

// ------------------------------------------------------------------------ //
// wgrad, bf16 on the tensor cores, for c_dec, c_out <= 32:                  //
// wgrad_ring_kernel.  Per (b, h) row of gy, dWc[tap] += d_shifted^T gy as  //
// mma.sync m16n8k16 with M = 32 channels c, N = 32 outputs o and K = the   //
// row's W*T real positions of gy, rounded up to 16 (gy is zero past them). //
// ------------------------------------------------------------------------ //
//
// - Channels-last tiles, no transposition.  d's rows are staged as
//   [position][CSP] slots of the zero-padded (W+2) x (T+2) halo grid, gy's
//   row as [position][CSP] over its W*T positions; CSP = 40 bf16 makes the
//   position stride 80 bytes, so the 8 rows of an ldmatrix fall in distinct
//   banks.  Both operands' fragments come from ldmatrix.x4.trans: A = d^T
//   (16 channels x 16 positions) and B = gy (16 positions x 2 x 8 outputs).
//   ldmatrix takes one address per row, so gy position k = w T + t reads
//   the halo row (w + dw) (T+2) + t + dt of tap (dw, dt) (prow[k] is its
//   centre tap, (w + 1) (T+2) + t + 1): any shift, odd or even, is a row
//   address, and K runs over the real positions (198 -> 208 at 22 x 9, not
//   the 272 of the padded grid).
// - Copies off the critical path.  A (b, h) row of d or gy is one
//   contiguous span of [B, H, W, T, C], aligned to one element only: it
//   lands whole in a raw buffer by 16-byte cp.async from the chunk below
//   its start (copy_async), and the threads then repack 16 bytes of
//   channels a position into the slot, zeros for channels c_dec..32 (or
//   c_out..32).  The next item's new d row and its gy row are in flight
//   while the tensor cores work on this item.
// - The ring.  A block walks a contiguous run of (b, h) items; rows
//   h - 1 .. h + 1 of d sit in slots row % 3, so one new d row is staged
//   per item; at the block's first item and at each image's row 0 the ring
//   restarts (the rows of the image around h, one copy at a time).  A warp
//   whose h tap reads a row outside [0, H) skips its products (a zero row).
// - Accumulators: warp w of 9 owns the taps (dh, dw) = (w / 3, w % 3), dt =
//   0..2: 3 x 32 x 32 float32 sums (96 a lane) in registers across the
//   block's items, written once to the block's slot, zeros where it had no
//   item (the reduce sums all G slots).  A k-step is 8 ldmatrix and 24
//   mma, unrolled two deep and scheduled by the compiler: 9 warps leave
//   168 registers a thread (three warps on one of the SM's four register
//   files), and fragments double-buffered by hand spilled and ran 4%
//   slower.
// - Rounding: bf16 x bf16 products are exact in float32 and summed there
//   (mma.sync's float32 accumulators), as by the plain version; only the
//   order of the sums differs.
//
// What bounds it on an H100: 2 * 27 * c_dec * c_out FLOP a position, 24.1
// GFLOP at the flagship's N = 557,568 and 25 -> 32 (0.0244 ms at the 989
// TFLOP/s bf16 peak) against 63.6 MB of d and gy read (0.019 ms):
// operations.  It issues 32 * 32 products a position of the 25 * 32 needed
// and 208 of 198 positions a row, 1.35x the work.  Shared memory at 22 x 9:
// three d slots of 24 * 11 * 80 B, the gy slot of 208 * 80 B, the raw rows
// (9,936 B of d, 12,704 B of gy) and prow: 103,472 B, one block per SM (its
// 288 threads take the registers).  W = 48 at T = 9 fits (217,600 B), and
// so does T = 19 at W = 22 (204,960 B); shapes whose layout exceeds shared
// memory (W = 100 at T = 9) take wgrad_kernel on the CUDA cores
// (wgrad_route, before any launch).

constexpr int WGR_WARPS = 9;
constexpr int WGR_CSP = 40;   // bf16 channel stride of a staged position

// Shared-memory bytes of wgrad_ring_kernel; the raw buffers' elements in
// *dbuf, *gbuf.
size_t wgrad_ring_smem(int W, int Tn, int c_dec, int c_out,
                       int* dbuf = nullptr, int* gbuf = nullptr) {
  const size_t e = sizeof(__nv_bfloat16), wt = (size_t)W * Tn;
  const size_t npk = (wt + 15) / 16 * 16;
  const size_t db = probav::run_buf_bytes(e * wt * c_dec);
  const size_t gb = probav::run_buf_bytes(e * wt * c_out);
  if (dbuf) *dbuf = (int)(db / e);
  if (gbuf) *gbuf = (int)(gb / e);
  return e * WGR_CSP * (3 * (size_t)(W + 2) * (Tn + 2) + npk) + db + gb +
         sizeof(int) * npk;
}

__global__ void __launch_bounds__(WGR_WARPS * 32)
wgrad_ring_kernel(const __nv_bfloat16* __restrict__ d,
                  const __nv_bfloat16* __restrict__ gy,
                  float* __restrict__ part, long slot_len, int B, int H,
                  int W, int Tn, int c_dec, int c_out, int dbuf_elems,
                  int gbuf_elems) {
  using E = __nv_bfloat16;
  using probav::copy_async;
  using probav::ldsm_x4_trans;
  using probav::mma_bf16;
  using probav::pack2;
  constexpr int CSP = WGR_CSP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T2 = Tn + 2, WT = W * Tn, npk = (WT + 15) / 16 * 16;
  const int slot_elems = (W + 2) * T2 * CSP;
  E* slots = reinterpret_cast<E*>(smem_raw);   // [3][W+2][T+2][CSP]
  E* gsl = slots + 3 * slot_elems;             // [npk][CSP]
  E* dbuf = gsl + npk * CSP;                   // a raw row of d
  E* gbuf = dbuf + dbuf_elems;                 // a raw row of gy
  int* prow = reinterpret_cast<int*>(gbuf + gbuf_elems);   // [npk]
  const E zero = __float2bfloat16_rn(0.f);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int dh = warp / 3, dw = warp % 3;

  // Zeros on the halo borders and on gy past its W*T positions, never
  // written again; the halo row of each position's centre tap (position
  // 0's past the row, where gy is zero).
  for (int e = tid; e < (3 * slot_elems + npk * CSP) / 8; e += nthr)
    reinterpret_cast<uint4*>(slots)[e] = make_uint4(0, 0, 0, 0);
  for (int k = tid; k < npk; k += nthr) {
    const int p = k < WT ? k : 0;
    prow[k] = (p / Tn + 1) * T2 + p % Tn + 1;
  }
  // A raw row (W*T positions of cn channels from buf) -> dst: position p
  // to row prow[p] (a d slot) or p (the gy slot); channels 0..32, zero
  // from cn; 16 bytes of a position per step.
  auto repack = [&](E* dst, const E* buf, int cn, bool halo) {
    for (int u = tid; u < WT * 4; u += nthr) {
      const int p = u / 4, j = u % 4;
      const E* s = buf + p * cn + 8 * j;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 8 * j + 2 * k;
        v[k] = pack2(c < cn ? s[2 * k] : zero,
                     c + 1 < cn ? s[2 * k + 1] : zero);
      }
      *reinterpret_cast<uint4*>(dst + (halo ? prow[p] : p) * CSP + 8 * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto copy_d = [&](long b, int hh) {
    return copy_async(dbuf, d + (b * H + hh) * (long)WT * c_dec, WT * c_dec);
  };
  auto copy_g = [&](long item) {
    return copy_async(gbuf, gy + item * (long)WT * c_out, WT * c_out);
  };

  const long items = (long)B * H;
  const long per = (items + gridDim.x - 1) / gridDim.x;
  const long i0 = min(items, (long)blockIdx.x * per);
  const long i1 = min(items, i0 + per);
  // The first row of d an item stages, or -1: at a restart (the block's
  // first item, an image's row 0) rows h - 1 .. h + 1 within the image,
  // else row h + 1.
  auto first_row = [&](long item) {
    const int h = (int)(item % H);
    const int lo = (item == i0 || h == 0) ? max(h - 1, 0) : h + 1;
    return lo < H ? lo : -1;
  };

  float acc[3][2][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[t][m][nt][0] = acc[t][m][nt][1] = acc[t][m][nt][2] =
            acc[t][m][nt][3] = 0.f;

  // This lane's ldmatrix rows: A (matrix j = lane / 8: positions 8 (j / 2)
  // on, channels 8 (j % 2) on; + 16 for the second m-tile), B (positions
  // 8 (j % 2) on, outputs 8 (j / 2) on; + 16 for the second pair of
  // n-tiles).  A's row is the halo row of its position at tap (dw, dt):
  // prow + (dw - 1) (T+2) + dt - 1.
  const int pa = 8 * (lane / 16) + lane % 8;
  const int aoff = ((dw - 1) * T2 - 1) * CSP + 8 * ((lane / 8) % 2);
  const E* bbase = gsl + (8 * ((lane / 8) % 2) + lane % 8) * CSP +
                   8 * (lane / 16);
  const int nk = npk / 16;

  int dsk = 0, gsk = 0;   // element offsets of the spans in dbuf, gbuf
  if (i0 < i1) {
    dsk = copy_d(i0 / H, first_row(i0));
    gsk = copy_g(i0);
    probav::cp_async_commit();
  }
  for (long item = i0; item < i1; ++item) {
    const long b = item / H;
    const int h = (int)(item % H);
    const int lo = first_row(item), hi = min(h + 1, H - 1);
    probav::cp_async_wait_all();
    __syncthreads();   // the copies landed; the last item's products done
    repack(gsl, gbuf + gsk, c_out, false);
    if (lo >= 0) repack(slots + (lo % 3) * slot_elems, dbuf + dsk, c_dec, true);
    for (int r = lo + 1; lo >= 0 && r <= hi; ++r) {   // a restart's rows
      __syncthreads();   // dbuf repacked
      dsk = copy_d(b, r);
      probav::cp_async_commit();
      probav::cp_async_wait_all();
      __syncthreads();
      repack(slots + (r % 3) * slot_elems, dbuf + dsk, c_dec, true);
    }
    __syncthreads();   // ring and gy slot staged; the raw buffers free
    if (item + 1 < i1) {
      const int r = first_row(item + 1);
      if (r >= 0) dsk = copy_d((item + 1) / H, r);
      gsk = copy_g(item + 1);
      probav::cp_async_commit();
    }
    const int hh = h + dh - 1;
    if (hh < 0 || hh >= H) continue;   // a zero row of d
    const E* abase = slots + (hh % 3) * slot_elems + aoff;
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t bf[2][4];
      ldsm_x4_trans(bf[0], bbase + kk * 16 * CSP);
      ldsm_x4_trans(bf[1], bbase + kk * 16 * CSP + 16);
      const E* ap = abase + prow[kk * 16 + pa] * CSP;
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          ldsm_x4_trans(a, ap + t * CSP + m * 16);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[t][m][2 * np], a, bf[np][0], bf[np][1]);
            mma_bf16(acc[t][m][2 * np + 1], a, bf[np][2], bf[np][3]);
          }
        }
    }
  }

  float* out = part + blockIdx.x * slot_len;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = m * 16 + g + (i < 2 ? 0 : 8);
          const int o = nt * 8 + 2 * q + (i & 1);
          const int tap = dh * 9 + dw * 3 + t;
          if (c < c_dec && o < c_out)
            out[((long)tap * c_dec + c) * c_out + o] = acc[t][m][nt][i];
        }
}

cudaError_t launch_wgrad_ring(const void* d, const void* gy, float* part,
                              long slot_len, int G, int B, int H, int W,
                              int Tn, int c_dec, int c_out, cudaStream_t s) {
  int dbuf = 0, gbuf = 0;
  const size_t smem = wgrad_ring_smem(W, Tn, c_dec, c_out, &dbuf, &gbuf);
  auto kern = wgrad_ring_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G, WGR_WARPS * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(gy), part, slot_len, B, H, W, Tn,
      c_dec, c_out, dbuf, gbuf);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// wgrad, bf16 on the tensor cores, for c_dec or c_out beyond 32, up to 64   //
// (the 64-filter model's 51 -> 64, the 48-filter model's 38 -> 48):        //
// wgrad_tiles_kernel, wgrad_ring_kernel's products in 32 x 32 channel      //
// tiles over the grid, its staging moved to producer warps of their own.  //
// ------------------------------------------------------------------------ //
//
// - Tiles.  Block s * tiles + t takes channel tile t (32 c's from c0 by 32
//   o's from o0; 2 x 2 at 64/51) of the items of slot s, the items cut
//   into G runs as in wgrad_ring_kernel; a slot's tiles are adjacent, so
//   they run together and read each row of d and gy from L2 once it is in.
//   Each writes its tile of dWc in its slot: every entry one writer.
// - Products taken the other way round: dWc^T[tap] += gy^T d_shifted, A =
//   gy^T (16 o x 16 positions, one load for a warp's three taps), B = d
//   shifted (16 positions x 8 c) by ldmatrix.trans on the halo rows, so a
//   tile's c's pad to 8, not 16 (51 -> 56, 38 -> 40); the n-tiles and
//   m-tiles past its channels are left out at compile time (wgrad_tile_mma,
//   one instantiation a shape: a branch in the k-loop kept the compiler
//   from interleaving loads and products, 0.81 ms against 0.60 at 64/51).
// - Warp specialisation.  With the staging done by the same warps between
//   two barriers an item, as in wgrad_ring_kernel, the four tiles' copies
//   and repacks ran serial with the products: 0.56 ms at 64/51, against
//   0.44 with producer warps (tools/time_conv.py).  Here 9 consumer warps
//   (one per (dh, dw) tap pair, as there) only multiply, and 3 producer
//   warps copy each item's raw rows of d an item ahead (16-byte cp.async
//   from the chunk below each row) and repack the tile's 32 channels of a
//   position by 32-bit words (five a step, realigned by a byte permute
//   where they start on an odd element, masked where they reach c_dec)
//   into the ring.  Named barriers hand the items over: FULL (ids 1, 2 by
//   item parity), the producers' bar.arrive after staging, the consumers'
//   bar.sync before their products; EMPTY (ids 3, 4), the consumers'
//   bar.arrive after them, the producers' bar.sync of item j - 1 before
//   they copy item j + 1's gy into its slot (and of the last two at the
//   end, so that every phase completes); id 5 orders the producer warps'
//   copies and reads of the raw buffers.  gy goes straight into its slot
//   by 16-byte cp.async where c_out % 8 == 0 (the tile's four 8-channel
//   pieces a position, zeros from c_out), else through a raw row and the
//   repack.  Three producer warps: 12 warps are 3 a scheduler, the 168
//   registers a thread of 9.
// - Slots.  gy's slot by item parity; the rows of d in a ring of
//   WTL_RING = 5 slots by the count of rows staged (not by row % 3): while
//   an item is staged, the one before may still be read, and its rows are
//   the last three staged; an item stages at most two (an image's rows 0
//   and 1), so the rows it overwrites are five back, out of the last
//   three.  The block's first item stages up to three rows, one at a time
//   (nothing is in flight).  tbl[parity][dh] gives the consumers the ring
//   slot of row h + dh - 1, -1 for a row outside the image (a zero row).
//
// Bound at N = 557,568, 51 -> 64: 98.3 GFLOP (0.0994 ms at the bf16 peak)
// against 128.6 MB read (0.038 ms): operations.  Shared memory at 22 x 9,
// 64/51: five d slots of 24 * 11 * 80 B, two gy slots of 208 * 80 B, two
// raw rows of d (20,224 B each), one of gy (25,376 B), prow and tbl:
// 205,568 B, one block of 12 warps an SM; where it does not fit (W = 48
// at 64/51, T = 19) the CUDA cores (wgrad_route).

constexpr int WTL_PRODUCERS = 3;   // warps that stage (3 a scheduler)
constexpr int WTL_THREADS = (WGR_WARPS + WTL_PRODUCERS) * 32;
constexpr int WTL_RING = 5;        // ring slots of d rows
constexpr int WTL_RAW = 2;         // raw rows of d an item stages at most
enum WtlBarrier { WTL_FULL = 1, WTL_EMPTY = 3, WTL_PRODUCE = 5 };

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared-memory bytes of wgrad_tiles_kernel; a raw row's elements in
// *dbuf (d) and *gbuf (gy).
size_t wgrad_tiles_smem(int W, int Tn, int c_dec, int c_out,
                        int* dbuf = nullptr, int* gbuf = nullptr) {
  const size_t e = sizeof(__nv_bfloat16), wt = (size_t)W * Tn;
  const size_t npk = (wt + 15) / 16 * 16;
  const size_t db = probav::run_buf_bytes(e * wt * c_dec);
  const size_t gb = probav::run_buf_bytes(e * wt * c_out);
  if (dbuf) *dbuf = (int)(db / e);
  if (gbuf) *gbuf = (int)(gb / e);
  return e * WGR_CSP *
             (WTL_RING * (size_t)(W + 2) * (Tn + 2) + 2 * npk) +
         WTL_RAW * db + gb + sizeof(int) * (npk + 8);
}

// One item's products of a consumer warp's three taps (dw, dt = 0..2) on a
// tile of NCT 8-channel n-tiles and NMT 16-output m-tiles: dWc^T[tap] +=
// gy^T d_shifted, A = gy^T from the gy slot at ag (+ 16 for the second
// m-tile), B = d from the halo rows at bb + prow (+ 16 for the second pair
// of n-tiles).  acc[t][m][nt]: outputs o 16 m.., channels c 8 nt..
template <int NCT, int NMT>
__device__ __forceinline__ void wgrad_tile_mma(
    float (&acc)[3][2][4][4], const __nv_bfloat16* ag,
    const __nv_bfloat16* bb, const int* prow, int pb, int nk) {
  constexpr int CSP = WGR_CSP;
#pragma unroll 2
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[NMT][4];
#pragma unroll
    for (int m = 0; m < NMT; ++m)
      probav::ldsm_x4_trans(af[m], ag + kk * 16 * CSP + 16 * m);
    const __nv_bfloat16* bp = bb + prow[kk * 16 + pb] * CSP;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int np = 0; np < (NCT + 1) / 2; ++np) {
        uint32_t bf[4];
        probav::ldsm_x4_trans(bf, bp + t * CSP + 16 * np);
#pragma unroll
        for (int m = 0; m < NMT; ++m) {
          probav::mma_bf16(acc[t][m][2 * np], af[m], bf[0], bf[1]);
          if (2 * np + 1 < NCT)
            probav::mma_bf16(acc[t][m][2 * np + 1], af[m], bf[2], bf[3]);
        }
      }
  }
}

__global__ void __launch_bounds__(WTL_THREADS, 1)
wgrad_tiles_kernel(const __nv_bfloat16* __restrict__ d,
                   const __nv_bfloat16* __restrict__ gy,
                   float* __restrict__ part, long slot_len, int B, int H,
                   int W, int Tn, int c_dec, int c_out, int dbuf_elems,
                   int gbuf_elems) {
  using E = __nv_bfloat16;
  constexpr int CSP = WGR_CSP, RING = WTL_RING, NT = WTL_THREADS;
  constexpr int CT = WGR_WARPS * 32;   // consumer threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T2 = Tn + 2, WT = W * Tn, npk = (WT + 15) / 16 * 16;
  const int slot_elems = (W + 2) * T2 * CSP, gsl_elems = npk * CSP;
  E* ring = reinterpret_cast<E*>(smem_raw);   // [RING][W+2][T+2][CSP]
  E* gsl = ring + RING * slot_elems;          // [2][npk][CSP]
  E* draw = gsl + 2 * gsl_elems;              // [WTL_RAW] raw rows of d
  E* graw = draw + WTL_RAW * dbuf_elems;      // a raw row of gy
  int* prow = reinterpret_cast<int*>(graw + gbuf_elems);   // [npk]
  int* tbl = prow + npk;                      // [2][3] ring slots
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tc = (c_dec + 31) / 32, tiles = tc * ((c_out + 31) / 32);
  const int tile = (int)(blockIdx.x % tiles);
  const int c0 = 32 * (tile % tc), o0 = 32 * (tile / tc);
  const int slot = (int)(blockIdx.x / tiles);
  const int nslots = (int)(gridDim.x / tiles);

  // Zeros on the halo borders and on gy past its W*T positions, never
  // written again; the halo row of each position's centre tap (position
  // 0's past the row, where gy is zero).
  for (int e = tid; e < (RING * slot_elems + 2 * gsl_elems) / 8; e += NT)
    reinterpret_cast<uint4*>(ring)[e] = make_uint4(0, 0, 0, 0);
  for (int k = tid; k < npk; k += NT) {
    const int p = k < WT ? k : 0;
    prow[k] = (p / Tn + 1) * T2 + p % Tn + 1;
  }
  __syncthreads();

  const long items = (long)B * H;
  const long per = (items + nslots - 1) / nslots;
  const long i0 = min(items, (long)slot * per);
  const long i1 = min(items, i0 + per);
  // The first row of d an item stages, or -1 (wgrad_ring_kernel's).
  auto first_row = [&](long item) {
    const int h = (int)(item % H);
    const int lo = (item == i0 || h == 0) ? max(h - 1, 0) : h + 1;
    return lo < H ? lo : -1;
  };

  if (warp >= WGR_WARPS) {
    // Producers: stage item by item, one ahead of the consumers.
    const int ptid = tid - CT, pn = NT - CT;
    // src[0, n) into buf by 16-byte cp.async from the chunk below src;
    // returns src[0]'s element offset in buf (probav::copy_async).
    auto copy = [&](E* buf, const E* src, int n) {
      const uintptr_t s = reinterpret_cast<uintptr_t>(src);
      const uintptr_t a = s & ~uintptr_t(15);
      const int chunks = (int)((s + 2 * (uintptr_t)n + 15 - a) / 16);
      for (int i = ptid; i < chunks; i += pn)
        probav::cp_async16(reinterpret_cast<char*>(buf) + 16 * i,
                           a + 16 * (uintptr_t)i);
      return (int)((s - a) / 2);
    };
    // Channels ch0 .. ch0 + 32 of each position of a raw row (cn channels
    // from element skew of base) into dst: position p to row prow[p] (a d
    // slot) or p (a gy slot), 8 channels a step from five 32-bit words.
    auto repack = [&](E* dst, const E* base, int skew, int cn, int ch0,
                      bool halo) {
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(base);
      for (int u = ptid; u < WT * 4; u += pn) {
        const int p = u / 4, j = u % 4;
        const int c = ch0 + 8 * j, left = cn - c;
        const int e = left > 0 ? skew + p * cn + c : 0;
        const uint32_t* w = bw + e / 2;
        const uint32_t sel = e & 1 ? 0x5432u : 0x3210u;
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __byte_perm(w[k], w[k + 1], sel);
        if (left < 8) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] &= (2 * k < left ? 0xffffu : 0u) |
                    (2 * k + 1 < left ? 0xffff0000u : 0u);
        }
        *reinterpret_cast<uint4*>(dst + (halo ? prow[p] : p) * CSP + 8 * j) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    };
    auto d_row = [&](long b, int r) { return d + (b * H + r) * WT * c_dec; };
    // gy of an item straight into a gy slot where its rows allow 16-byte
    // copies of 8 channels (c_out % 8 == 0): the tile's four a position,
    // zeros from c_out; else through the raw row and repack.
    const bool gdirect = c_out % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(gy) % 16 == 0;
    auto copy_gy = [&](E* dst, long item) {
      const E* src = gy + item * WT * c_out + o0;
      for (int u = ptid; u < WT * 4; u += pn) {
        const int p = u / 4, j = u % 4;
        const bool in = o0 + 8 * j < c_out;
        probav::cp_async16_zfill(dst + p * CSP + 8 * j,
                                 in ? src + p * c_out + 8 * j : gy, in);
      }
    };
    // Ring slots of rows h - 1, h, h + 1, the rows staged, the raw rows'
    // skews (scalars: an indexed array would live in local memory).
    int rs0 = -1, rs1 = -1, rs2 = -1, staged = 0, dsk0 = 0, dsk1 = 0, gsk = 0;
    auto put = [&](int k, int sl) {
      rs0 = k == 0 ? sl : rs0;
      rs1 = k == 1 ? sl : rs1;
      rs2 = k == 2 ? sl : rs2;
    };
    for (long item = i0; item < i1; ++item) {
      const long b = item / H;
      const int h = (int)(item % H), par = (int)((item - i0) & 1);
      const int lo = first_row(item), hi = min(h + 1, H - 1);
      if (item == i0 || h == 0) {
        rs0 = rs1 = rs2 = -1;
      } else {
        rs0 = rs1;
        rs1 = rs2;
        rs2 = -1;
      }
      if (item == i0) {   // rows one at a time through the first raw row
        if (gdirect)
          copy_gy(gsl + par * gsl_elems, item);
        else
          gsk = copy(graw, gy + item * WT * c_out, WT * c_out);
        for (int r = lo; r <= hi; ++r) {
          const int sk = copy(draw, d_row(b, r), WT * c_dec);
          probav::cp_async_commit();
          probav::cp_async_wait_all();
          bar_sync(WTL_PRODUCE, pn);   // the row landed
          const int s = staged++ % RING;
          repack(ring + s * slot_elems, draw, sk, c_dec, c0, true);
          put(r - h + 1, s);
          bar_sync(WTL_PRODUCE, pn);   // the raw row read
        }
      } else {
        probav::cp_async_wait_all();
        bar_sync(WTL_PRODUCE, pn);     // the rows copied during the last
        for (int r = lo; lo >= 0 && r <= hi; ++r) {
          const int s = staged++ % RING;
          repack(ring + s * slot_elems, draw + (r - lo) * dbuf_elems,
                 r == lo ? dsk0 : dsk1, c_dec, c0, true);
          put(r - h + 1, s);
        }
      }
      if (!gdirect)
        repack(gsl + par * gsl_elems, graw, gsk, c_out, o0, false);
      if (ptid == 0) {
        tbl[3 * par] = rs0;
        tbl[3 * par + 1] = rs1;
        tbl[3 * par + 2] = rs2;
      }
      bar_sync(WTL_PRODUCE, pn);   // raw rows read, slots written
      bar_arrive(WTL_FULL + par, NT);
      if (item + 1 < i1) {   // the next item's rows (at most two) and gy
        const long nb = (item + 1) / H;
        const int nh = (int)((item + 1) % H), nlo = first_row(item + 1);
        const int npar = par ^ 1;
        for (int r = nlo; nlo >= 0 && r <= min(nh + 1, H - 1); ++r) {
          const int sk = copy(draw + (r - nlo) * dbuf_elems, d_row(nb, r),
                              WT * c_dec);
          if (r == nlo) dsk0 = sk; else dsk1 = sk;
        }
        // Item - 1 read: its gy slot, the ring slots that the next item
        // restages and its tbl row are free.
        if (item + 1 - i0 >= 2) bar_sync(WTL_EMPTY + npar, NT);
        if (gdirect)
          copy_gy(gsl + npar * gsl_elems, item + 1);
        else
          gsk = copy(graw, gy + (item + 1) * WT * c_out, WT * c_out);
        probav::cp_async_commit();
      }
    }
    for (long item = max(i0, i1 - 2); item < i1; ++item)
      bar_sync(WTL_EMPTY + (int)((item - i0) & 1), NT);
    return;
  }

  // Consumers: warp w of 9 owns the taps (dh, dw) = (w / 3, w % 3), dt =
  // 0..2, of the tile's 32 o's by 32 c's, in registers across the items.
  const int g = lane / 4, q = lane % 4;
  const int dh = warp / 3, dw = warp % 3;
  const int pb = 8 * ((lane / 8) % 2) + lane % 8;
  const int boff = ((dw - 1) * T2 - 1) * CSP + 8 * (lane / 16);
  const int aoff = (8 * (lane / 16) + lane % 8) * CSP + 8 * ((lane / 8) % 2);
  const int nct = (min(32, c_dec - c0) + 7) / 8;
  const int nmt = (min(32, c_out - o0) + 15) / 16;
  const int nk = npk / 16;
  float acc[3][2][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[t][m][nt][0] = acc[t][m][nt][1] = acc[t][m][nt][2] =
            acc[t][m][nt][3] = 0.f;
  for (long item = i0; item < i1; ++item) {
    const int par = (int)((item - i0) & 1);
    bar_sync(WTL_FULL + par, NT);   // the item staged
    const int s = tbl[3 * par + dh];
    if (s >= 0) {   // else a zero row of d
      const E* ag = gsl + par * gsl_elems + aoff;
      const E* bb = ring + s * slot_elems + boff;
      switch (2 * (nct - 1) + nmt - 1) {
        case 0: wgrad_tile_mma<1, 1>(acc, ag, bb, prow, pb, nk); break;
        case 1: wgrad_tile_mma<1, 2>(acc, ag, bb, prow, pb, nk); break;
        case 2: wgrad_tile_mma<2, 1>(acc, ag, bb, prow, pb, nk); break;
        case 3: wgrad_tile_mma<2, 2>(acc, ag, bb, prow, pb, nk); break;
        case 4: wgrad_tile_mma<3, 1>(acc, ag, bb, prow, pb, nk); break;
        case 5: wgrad_tile_mma<3, 2>(acc, ag, bb, prow, pb, nk); break;
        case 6: wgrad_tile_mma<4, 1>(acc, ag, bb, prow, pb, nk); break;
        default: wgrad_tile_mma<4, 2>(acc, ag, bb, prow, pb, nk);
      }
    }
    bar_arrive(WTL_EMPTY + par, NT);   // its slots may be restaged
  }

  float* out = part + slot * slot_len;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = c0 + nt * 8 + 2 * q + (i & 1);
          const int o = o0 + m * 16 + g + (i < 2 ? 0 : 8);
          const int tap = dh * 9 + dw * 3 + t;
          if (c < c_dec && o < c_out)
            out[((long)tap * c_dec + c) * c_out + o] = acc[t][m][nt][i];
        }
}

cudaError_t launch_wgrad_tiles(const void* d, const void* gy, float* part,
                               long slot_len, int G, int B, int H, int W,
                               int Tn, int c_dec, int c_out, cudaStream_t s) {
  int dbuf = 0, gbuf = 0;
  const size_t smem = wgrad_tiles_smem(W, Tn, c_dec, c_out, &dbuf, &gbuf);
  auto kern = wgrad_tiles_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (c_dec + 31) / 32 * ((c_out + 31) / 32);
  kern<<<G * tiles, WTL_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(gy), part, slot_len, B, H, W, Tn,
      c_dec, c_out, dbuf, gbuf);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// seg_bwd: x, dd, gy [n, *] -> dx [n, c_in] and the dW1/dW2/db1/db2/dbc      //
// partials.  CI, CD: the 32-channel buckets of c_in, c_dec.  One row per   //
// thread: its dx sums in registers, and its x and dd rows too where they   //
// fit beside them (CI <= 64, CI + CD <= 128), else read from the shared    //
// tile (odd stride: no bank conflicts; loops over them unrolled 4 deep,    //
// not whole).  dbc: thread k < c_in sums channel k of gy over the tile's   //
// rows in order, from the tile in shared memory.                          //
// WIDE (the wide block's backward): no gy, dx = W1 dz, no dbc, and dz and  //
// relu(z) are not rounded to T.                                            //
// ------------------------------------------------------------------------ //

template <typename T, int CI, int CD, bool WIDE>
__global__ void __launch_bounds__(BWD_ROWS)
seg_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dd,
               const T* __restrict__ gy, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               T* __restrict__ dx, float* __restrict__ part, long slot_len,
               int n, int c_in, int c_mid, int c_dec) {
  constexpr int RS = (CI > CD ? CI : CD) + 1;   // odd row stride
  constexpr int MQ = BWD_MCH / 4;               // 4-wide j groups per chunk
  constexpr int T1 = CI / 4 * MQ;               // dW1 4x4 tiles per chunk
  constexpr int T2 = MQ * (CD / 4);             // dW2 4x4 tiles per chunk
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                             // [R][RS]  x, later dx
  float* ds = xs + BWD_ROWS * RS;               // [R][RS]  dd
  float* zs = ds + BWD_ROWS * RS;               // [R][MS]  dz
  float* hs = zs + BWD_ROWS * BWD_MS;           // [R][MS]  h = relu(z)
  float* w1c = hs + BWD_ROWS * BWD_MS;          // [MCH][CI]  w1 transposed
  float* w2c = w1c + BWD_MCH * CI;              // [MCH][CD]
  float* b1c = w2c + BWD_MCH * CD;              // [MCH]
  static_assert(probav::MAX_CH <= BWD_ROWS, "a thread per dbc channel");
  constexpr bool REG = CI <= 64 && CI + CD <= 128;
  constexpr int KU = REG ? CI / 4 : 4, CU = REG ? CD / 4 : 4;   // unrolls

  const int tid = threadIdx.x;
  const Slot sl(c_in, c_mid, c_dec, !WIDE);
  float* slot = part + blockIdx.x * slot_len;
  for (long e = sl.w1 + tid; e < sl.bc; e += BWD_ROWS) slot[e] = 0.f;
  __syncthreads();

  float dbc_acc = 0.f;   // channel tid of dbc (tid < c_in)
  const long tiles = ((long)n + BWD_ROWS - 1) / BWD_ROWS;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * BWD_ROWS;
    const int nrows = (int)min((long)BWD_ROWS, (long)n - row0);
    __syncthreads();   // previous tile's epilogue done with xs
    for (int e = tid; e < BWD_ROWS * CI; e += BWD_ROWS) {
      const int r = e / CI, k = e % CI;
      xs[r * RS + k] =
          (r < nrows && k < c_in) ? to_f(x[(row0 + r) * c_in + k]) : 0.f;
    }
    for (int e = tid; e < BWD_ROWS * CD; e += BWD_ROWS) {
      const int r = e / CD, c = e % CD;
      ds[r * RS + c] =
          (r < nrows && c < c_dec) ? to_f(dd[(row0 + r) * c_dec + c]) : 0.f;
    }
    __syncthreads();
    float xr[REG ? CI : 1], dr[REG ? CD : 1], dxa[CI];
    const float* xo = xs + tid * RS;   // this thread's x and dd rows
    const float* dof = ds + tid * RS;
#pragma unroll
    for (int k = 0; k < CI; ++k) dxa[k] = 0.f;
    if constexpr (REG) {
#pragma unroll
      for (int k = 0; k < CI; ++k) xr[k] = xo[k];
#pragma unroll
      for (int c = 0; c < CD; ++c) dr[c] = dof[c];
    }
    auto xv = [&](int k) {
      if constexpr (REG) return xr[k]; else return xo[k];
    };
    auto dv = [&](int c) {
      if constexpr (REG) return dr[c]; else return dof[c];
    };

    for (int j0 = 0; j0 < c_mid; j0 += BWD_MCH) {
      __syncthreads();   // previous chunk's sums done with zs, hs, w1c
      for (int e = tid; e < BWD_MCH * CI; e += BWD_ROWS) {
        const int k = e / BWD_MCH, j = e % BWD_MCH;
        w1c[j * CI + k] = (k < c_in && j0 + j < c_mid)
                              ? to_f(w1[(long)k * c_mid + j0 + j]) : 0.f;
      }
      for (int e = tid; e < BWD_MCH * CD; e += BWD_ROWS) {
        const int j = e / CD, c = e % CD;
        w2c[e] = (c < c_dec && j0 + j < c_mid)
                     ? to_f(w2[(long)(j0 + j) * c_dec + c]) : 0.f;
      }
      if (tid < BWD_MCH) b1c[tid] = j0 + tid < c_mid ? b1[j0 + tid] : 0.f;
      __syncthreads();

      // One row per thread: z, W2 dd, dz, h for the chunk; dx += W1 dz.
      // Padded channels have zero weights and bias: dz and h are 0 there.
      for (int jj = 0; jj < BWD_MCH; jj += 4) {
        float z[4], g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) { z[q] = b1c[jj + q]; g[q] = 0.f; }
#pragma unroll (KU)
        for (int k = 0; k < CI; k += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w =
                *reinterpret_cast<const float4*>(w1c + (jj + q) * CI + k);
            z[q] = fmaf(xv(k), w.x, z[q]);
            z[q] = fmaf(xv(k + 1), w.y, z[q]);
            z[q] = fmaf(xv(k + 2), w.z, z[q]);
            z[q] = fmaf(xv(k + 3), w.w, z[q]);
          }
        }
#pragma unroll (CU)
        for (int c = 0; c < CD; c += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w =
                *reinterpret_cast<const float4*>(w2c + (jj + q) * CD + c);
            g[q] = fmaf(dv(c), w.x, g[q]);
            g[q] = fmaf(dv(c + 1), w.y, g[q]);
            g[q] = fmaf(dv(c + 2), w.z, g[q]);
            g[q] = fmaf(dv(c + 3), w.w, g[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float dz = z[q] > 0.f ? (WIDE ? g[q] : round_to<T>(g[q]))
                                      : 0.f;
          const float h = fmaxf(z[q], 0.f);
          zs[tid * BWD_MS + jj + q] = dz;
          hs[tid * BWD_MS + jj + q] = WIDE ? h : round_to<T>(h);
          const float4* w4 =
              reinterpret_cast<const float4*>(w1c + (jj + q) * CI);
#pragma unroll
          for (int k = 0; k < CI / 4; ++k) {
            const float4 w = w4[k];
            dxa[4 * k] = fmaf(dz, w.x, dxa[4 * k]);
            dxa[4 * k + 1] = fmaf(dz, w.y, dxa[4 * k + 1]);
            dxa[4 * k + 2] = fmaf(dz, w.z, dxa[4 * k + 2]);
            dxa[4 * k + 3] = fmaf(dz, w.w, dxa[4 * k + 3]);
          }
        }
      }
      __syncthreads();

      // Weight sums over the tile's rows, 4x4 outputs per thread and tile.
      for (int t = tid; t < T1 + T2; t += BWD_ROWS) {
        const bool first = t < T1;
        const int tt = first ? t : t - T1;
        // dW1: a = x[:, 4kq..], b = dz[:, 4jq..];  dW2: a = h, b = dd.
        const int aq = first ? tt / MQ : tt / (CD / 4);
        const int bq = first ? tt % MQ : tt % (CD / 4);
        const float* A = first ? xs + 4 * aq : hs + 4 * aq;
        const int as = first ? RS : BWD_MS;
        const float* Bm = first ? zs + 4 * bq : ds + 4 * bq;
        const int bs = first ? BWD_MS : RS;
        float acc[4][4], bsum[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bsum[i] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        }
        for (int r = 0; r < nrows; ++r) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = A[r * as + i];
            b[i] = Bm[r * bs + i];
            bsum[i] += b[i];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (first) {          // acc[i][j]: dW1[4aq + i][j0 + 4bq + j]
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = 4 * aq + i, jm = j0 + 4 * bq + j;
              if (k < c_in && jm < c_mid)
                slot[sl.w1 + (long)k * c_mid + jm] += acc[i][j];
            }
          if (aq == 0)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j0 + 4 * bq + j < c_mid)
                slot[sl.b1 + j0 + 4 * bq + j] += bsum[j];
        } else {              // acc[i][j]: dW2[j0 + 4aq + i][4bq + j]
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int jm = j0 + 4 * aq + i, c = 4 * bq + j;
              if (jm < c_mid && c < c_dec)
                slot[sl.w2 + (long)jm * c_dec + c] += acc[i][j];
            }
          if (aq == 0 && j0 == 0)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * bq + j < c_dec) slot[sl.b2 + 4 * bq + j] += bsum[j];
        }
      }
    }

    // Epilogue through shared memory: dx = W1 dz (+ gy), coalesced; gy
    // lands in ds (free once the last chunk's sums are done) for dbc.
    __syncthreads();   // the last chunk's sums are done with xs and ds
#pragma unroll
    for (int k = 0; k < CI; ++k) xs[tid * RS + k] = dxa[k];
    __syncthreads();
    const long base = row0 * c_in;
    for (int e = tid; e < nrows * c_in; e += BWD_ROWS) {
      const int r = e / c_in, k = e % c_in;
      if constexpr (WIDE) {
        dx[base + e] = from_f<T>(xs[r * RS + k]);
      } else {
        const float g = to_f(gy[base + e]);
        ds[r * RS + k] = g;
        dx[base + e] = from_f<T>(xs[r * RS + k] + g);
      }
    }
    if constexpr (!WIDE) {
      __syncthreads();
      if (tid < c_in)
        for (int r = 0; r < nrows; ++r) dbc_acc += ds[r * RS + tid];
    }
  }
  if constexpr (!WIDE) {
    if (tid < c_in) slot[sl.bc + tid] = dbc_acc;
  }
}

template <typename T, int CI, int CD, bool WIDE>
cudaError_t launch_seg_bwd(const void* x, const void* dd, const void* gy,
                           const void* w1, const float* b1, const void* w2,
                           void* dx, float* part, long slot_len, int G, int n,
                           int c_in, int c_mid, int c_dec, cudaStream_t s) {
  constexpr int RS = (CI > CD ? CI : CD) + 1;
  const size_t smem =
      sizeof(float) * ((size_t)2 * BWD_ROWS * RS + 2 * BWD_ROWS * BWD_MS +
                       BWD_MCH * (CI + CD + 1));
  auto kern = seg_bwd_kernel<T, CI, CD, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G, BWD_ROWS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dd),
      static_cast<const T*>(gy), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), static_cast<T*>(dx), part, slot_len, n, c_in,
      c_mid, c_dec);
  return cudaGetLastError();
}

template <typename T, bool WIDE = false>
cudaError_t dispatch_seg_bwd(const void* x, const void* dd, const void* gy,
                             const void* w1, const float* b1, const void* w2,
                             void* dx, float* part, long slot_len, int G,
                             int n, int c_in, int c_mid, int c_dec,
                             cudaStream_t s) {
  return probav::by_bucket(c_in, [&](auto ci) {
    return probav::by_bucket(c_dec, [&](auto cd) {
      return launch_seg_bwd<T, decltype(ci)::value, decltype(cd)::value,
                            WIDE>(x, dd, gy, w1, b1, w2, dx, part, slot_len,
                                  G, n, c_in, c_mid, c_dec, s);
    });
  });
}

// ------------------------------------------------------------------------ //
// seg_bwd, bf16 on the tensor cores (mma.sync.m16n8k16, float32 sums), for  //
// c_in, c_dec <= 32 and c_mid <= 256 (the flagship's 32/256/25):           //
// seg_bwd_bf16_kernel.  It computes what seg_bwd_kernel<__nv_bfloat16, ..., //
// false> computes, into the same slot layout, with the same rounding       //
// points.                                                                  //
// ------------------------------------------------------------------------ //
//
// - Transposed products, so that every C fragment feeds the next product
//   in registers.  Warp w owns the middle channels j of 32 w .. 32 w + 31
//   (two 16-row m-tiles) over every row of a tile, 16 rows at a time:
//   z^T = W1^T x^T + b1 and W2 dd^T come out of the mma as 16 j x 8 row C
//   tiles, dz^T = relu'(z) (W2 dd) and h^T = relu(z) are rounded to bf16
//   in registers, and two C tiles adjacent in rows are the A fragment of
//   dW1^T += dz^T x and of dW2 += h^T dd (K = the 16 rows).  So the warp's
//   weight gradients sum in its own registers across all of the block's
//   tiles, written once to the block's slot, and W1^T and W2's A fragments
//   (its 32 j x 32 c of each) are loaded once per block and stay in
//   registers.  h never leaves registers.  A warp whose j are all past
//   c_mid runs too: its weights and b1 are zero, so it writes zero dz.
// - dx = dz W1^T + gy needs every j of a row: dz^T goes to shared memory as
//   bf16x2 words ([j][row], stride ROWS + 8: conflict-free), into one of
//   two buffers, and warp w computes dx for 16 rows (phase C), A = dz from
//   dz^T and B = W1^T from the one [j][c] copy of W1, both by
//   ldmatrix.trans.  Phase C of a tile runs during the block's next tile,
//   two of its 16 k-steps beside each 16 rows' products, so that its mma
//   and loads fill the gaps of the products' relu and rounding: one
//   barrier a tile.
// - Row-major channels-last tiles and ldmatrix fragments: x [row][40]
//   (80-byte rows: the 8 rows of an ldmatrix in distinct banks) gives the B
//   of z^T by ldmatrix and the B of dW1^T by ldmatrix.trans, and dd the
//   same for W2 dd^T and dW2.  x rows (64 bytes at c_in = 32) land by
//   16-byte cp.async into a double buffer, the next tile's while this one
//   computes.  dd rows are 50 bytes (c_dec = 25): warp w copies its 16
//   rows of the next tile's dd, one contiguous span, into its own raw
//   buffer (16-byte cp.async from the chunk below the span's start) and
//   repacks them into [row][40], zeros past c_dec and past n; and copies
//   the gy of those rows.  Only warp-level barriers guard its own copies.
// - Epilogue: dx + gy in float32, rounded to bf16, staged in place of the
//   warp's gy rows, and stored as 16-byte row pieces; dbc sums gy from the
//   same loads.  db1 sums dz^T's C fragments and db2 dd's B fragments
//   (warp w those of row group w), per lane, reduced over the lanes and
//   warps in a fixed order at the end: no serial row walk.
// - Zeros past n: x and gy rows are zero-filled and dd rows repacked as
//   zeros, so rows past n add nothing (h there is relu(b1), against dd =
//   0).
//
// What bounds it on an H100 at the flagship (N = 557,568): 2 N c_mid (3 c_in
// + 2 c_dec) = 41.7 GFLOP (0.042 ms at the 989 TFLOP/s bf16 peak; the mma
// issue 45.7 GFLOP at c_dec padded to 32) against 135 MB of x, dd, gy read
// and dx written (0.040 ms): operations.  What holds it is mma.sync issue
// serialised with the relu and rounding (tools/seg_bwd_variants.py: the
// products alone would take about half its time).  One block of 8 warps an
// SM: 231,680 bytes of shared memory (W1 [256][40], two dz^T buffers
// [256][136], the first holding W2 while the fragments load, two each of
// the x, dd and gy tiles, the warps' raw dd spans), 234 registers.

constexpr int SBB_WARPS = 8;     // each owns 256 / SBB_WARPS middle channels
constexpr int SBB_ROWS = 128;    // rows per tile
constexpr int SBB_MINB = 1;      // blocks an SM (__launch_bounds__)
constexpr int SBB_CS = 40;       // bf16 row stride: x, dd, gy tiles; W1, W2
constexpr int SBB_ZS = SBB_ROWS + 8;   // dz^T [j][row] row stride
constexpr int SBB_RAWW = (16 * 64 + 43) / 16 * 8;   // a warp's raw dd span

size_t seg_bwd_bf16_smem() {
  return sizeof(__nv_bfloat16) *
             ((size_t)256 * (SBB_CS + 2 * SBB_ZS) + 6 * SBB_ROWS * SBB_CS +
              SBB_WARPS * SBB_RAWW) +
         sizeof(float) * 2 * SBB_WARPS * 32;
}

__global__ void __launch_bounds__(SBB_WARPS * 32, SBB_MINB)
seg_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dd,
                    const __nv_bfloat16* __restrict__ gy,
                    const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                    long slot_len, int n, int c_in, int c_mid, int c_dec) {
  using E = __nv_bfloat16;
  using probav::ldsm_x4;
  using probav::ldsm_x4_trans;
  using probav::mma_bf16;
  using probav::pack2;
  using probav::pack_bf16;
  using probav::relu_bf16x2;
  constexpr int ROWS = SBB_ROWS, CS = SBB_CS, ZS = SBB_ZS;
  constexpr int MT = 256 / (16 * SBB_WARPS);   // 16-j m-tiles a warp
  constexpr int RG = ROWS / 16;                // 16-row groups a tile
  constexpr int WPR = SBB_WARPS / RG;          // phase-C warps a row group
  constexpr int CTW = 4 / WPR;                 // phase-C 8-column tiles a warp
  constexpr int KPG = 16 / RG;                 // phase-C k-steps a row group
  static_assert(MT >= 1 && MT * 16 * SBB_WARPS == 256, "j per warp");
  static_assert(WPR >= 1 && WPR * RG == SBB_WARPS && CTW % 2 == 0,
                "phase-C rows and columns per warp");
  static_assert(KPG * RG == 16, "phase C's k-steps spread over the groups");
  static_assert(256 * ZS * 2 >= 256 * 32 * 4, "dW1 staged in the dz^T space");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* w1s = reinterpret_cast<E*>(smem_raw);   // [256][CS]  w1[c][j] at [j][c]
  E* zt = w1s + 256 * CS;                    // [2][256][ZS]  dz^T of tiles
  E* w2s = zt;                               // [256][CS]  w2, while loading
  E* xb = zt + 2 * 256 * ZS;                 // [2][ROWS][CS]  x tiles
  E* dbt = xb + 2 * ROWS * CS;               // [2][ROWS][CS]  dd tiles
  E* gyb = dbt + 2 * ROWS * CS;              // [2][ROWS][CS]  gy tiles
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  E* raw = gyb + 2 * ROWS * CS + warp * SBB_RAWW;   // this warp's dd span
  float* red = reinterpret_cast<float*>(gyb + 2 * ROWS * CS +
                                        SBB_WARPS * SBB_RAWW);   // [2][W][32]
  const E zero = __float2bfloat16_rn(0.f);
  const int g = lane / 4, q = lane % 4;
  const int J0 = warp * 16 * MT;             // this warp's middle channels
  const int pr0 = 16 * (warp % RG);          // its phase-C rows
  const int ct0 = CTW * (warp / RG);         // and 8-column tiles of dx

  // W1, W2 as [j][c], zero-padded to 256 x 32 (padded z, dz, h are 0); the
  // tiles zeroed once (the copies never write x's and gy's columns from
  // c_in on), and the dbc and db2 sums.
#pragma unroll
  for (int e = tid; e < 256 * 32; e += SBB_WARPS * 32) {
    const int c = e / 256, j = e % 256;
    w1s[j * CS + c] = (c < c_in && j < c_mid) ? w1[(long)c * c_mid + j] : zero;
    const int j2 = e / 32, c2 = e % 32;
    w2s[j2 * CS + c2] =
        (j2 < c_mid && c2 < c_dec) ? w2[(long)j2 * c_dec + c2] : zero;
  }
  for (int e = tid; e < 6 * ROWS * CS / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(xb)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < 2 * SBB_WARPS * 32; e += blockDim.x) red[e] = 0.f;
  __syncthreads();

  // This warp's A fragments of W1^T and W2 (M = its j, K = c) and its b1.
  uint32_t wa[MT][2][4], wb[MT][2][4];
  float bias[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = J0 + 16 * mt + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldsm_x4(wa[mt][ks], w1s + row * CS + 16 * ks + 8 * (lane / 16));
      ldsm_x4(wb[mt][ks], w2s + row * CS + 16 * ks + 8 * (lane / 16));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = J0 + 16 * mt + g + 8 * hh;
      bias[mt][hh] = j < c_mid ? b1[j] : 0.f;
    }
  }
  __syncthreads();   // w2s read: zt may be written

  float acc1[MT][4][4], acc2[MT][4][4];   // dW1^T (j, c), dW2 (j, c) tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][ct][i] = acc2[mt][ct][i] = 0.f;
  float db1a[MT][2] = {}, db2a[4] = {}, dbca[CTW][2] = {}, dxc[CTW][4];

  const bool vec = c_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  auto rows_of = [&](long t) {
    return (int)min((long)ROWS, (long)n - t * ROWS);
  };
  // Rows [0, nr) of x from tile t into dst (zeros past nr), block-wide:
  // 16-byte cp.async where `vec`, else plain copies.
  auto stage_x = [&](E* dst, long t, int nr) {
    const E* src = x + t * ROWS * c_in;
    if (vec) {
      const int c8 = c_in / 8;
      for (int e = tid; e < ROWS * c8; e += blockDim.x) {
        const int r = e / c8, c = 8 * (e % c8);
        const bool in = r < nr;
        probav::cp_async16_zfill(dst + r * CS + c,
                                 in ? src + r * c_in + c : src, in);
      }
    } else {
      for (int e = tid; e < ROWS * c_in; e += blockDim.x) {
        const int r = e / c_in, c = e % c_in;
        dst[r * CS + c] = r < nr ? src[r * c_in + c] : zero;
      }
    }
  };
  // This warp's 16 rows of dd from tile t: the span of its real rows, by
  // 16-byte cp.async from the chunk below its start; returns the element
  // offset of the span in raw.
  auto copy_dd = [&](long t) {
    const int nrw = min(16, rows_of(t) - pr0);
    if (nrw <= 0) return 0;
    const uintptr_t s = reinterpret_cast<uintptr_t>(
        dd + (t * ROWS + pr0) * c_dec);
    const uintptr_t a = s & ~uintptr_t(15);
    const int chunks = (int)((s + 2 * (uintptr_t)(nrw * c_dec) + 15 - a) / 16);
    for (int i = lane; i < chunks; i += 32)
      probav::cp_async16(raw + 8 * i, a + 16 * (uintptr_t)i);
    return (int)((s - a) / 2);
  };
  // ... and its repack into rows pr0 .. pr0 + 15 of a dd tile: 8 channels
  // a step, zeros from c_dec and past the tile's nr rows.
  auto repack = [&](E* dst, int skew, int nr) {
    const E* src = raw + skew;
    for (int u = lane; u < 16 * 4; u += 32) {
      const int p = u / 4, j = u % 4;
      const E* s = src + p * c_dec + 8 * j;
      const bool in = pr0 + p < nr;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 8 * j + 2 * k;
        v[k] = pack2(in && c < c_dec ? s[2 * k] : zero,
                     in && c + 1 < c_dec ? s[2 * k + 1] : zero);
      }
      *reinterpret_cast<uint4*>(dst + (pr0 + p) * CS + 8 * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  // This warp's gy rows of tile t into a gy tile (zeros past n).
  auto stage_gy = [&](E* dst, long t) {
    const int nrw = min(16, rows_of(t) - pr0);
    const E* src = gy + (t * ROWS + pr0) * c_in;
    if (vec) {
      for (int e = lane; e < 16 * CTW; e += 32) {
        const int r = e / CTW, c = 8 * (ct0 + e % CTW);
        const bool in = r < nrw && c < c_in;
        probav::cp_async16_zfill(dst + (pr0 + r) * CS + c,
                                 in ? src + r * c_in + c : gy, in);
      }
    } else {
      for (int e = lane; e < 16 * 8 * CTW; e += 32) {
        const int r = e / (8 * CTW), c = 8 * ct0 + e % (8 * CTW);
        dst[(pr0 + r) * CS + c] = r < nrw && c < c_in ? src[r * c_in + c]
                                                        : zero;
      }
    }
  };
  // Phase C, k-steps ks0 .. ks0 + nks - 1 (16 j each) of dx = dz W1^T for
  // rows pr0 .. pr0 + 15 and this warp's dx tiles, from the dz^T buffer z:
  // A = dz and B = W1^T, both by ldmatrix.trans.
  const int zoff = (8 * (lane / 16) + lane % 8) * ZS + pr0 +
                   8 * ((lane / 8) % 2);
  const E* wp = w1s + (8 * ((lane / 8) % 2) + lane % 8) * CS +
                8 * (ct0 + lane / 16);
  auto phase_c = [&](const E* z, int ks0, int nks) {
#pragma unroll
    for (int kk = 0; kk < nks; ++kk) {
      const int ks = ks0 + kk;
      uint32_t a[4];
      ldsm_x4_trans(a, z + zoff + ks * 16 * ZS);
#pragma unroll
      for (int p = 0; p < CTW / 2; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(b, wp + ks * 16 * CS + 16 * p);
        mma_bf16(dxc[2 * p], a, b[0], b[1]);
        mma_bf16(dxc[2 * p + 1], a, b[2], b[3]);
      }
    }
  };
  // The epilogue of tile t (gy and dx staged in the gy tile y): dx + gy in
  // float32, bf16, staged in place of this warp's gy, stored as 16-byte
  // pieces of rows; dbc sums gy.
  auto epilogue = [&](E* y, long t) {
    const int nrw = min(16, rows_of(t) - pr0);
#pragma unroll
    for (int c = 0; c < CTW; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int off = (pr0 + g + 8 * hh) * CS + 8 * (ct0 + c) + 2 * q;
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(y + off));
        dbca[c][0] += gv.x;
        dbca[c][1] += gv.y;
        *reinterpret_cast<uint32_t*>(y + off) =
            pack_bf16(dxc[c][2 * hh] + gv.x, dxc[c][2 * hh + 1] + gv.y);
      }
    __syncwarp();
    E* dst = dx + (t * ROWS + pr0) * c_in;
    if (vec) {
      for (int e = lane; e < 16 * CTW; e += 32) {
        const int r = e / CTW, c = 8 * (ct0 + e % CTW);
        if (r < nrw && c < c_in)
          *reinterpret_cast<uint4*>(dst + r * c_in + c) =
              *reinterpret_cast<const uint4*>(y + (pr0 + r) * CS + c);
      }
    } else {
      for (int e = lane; e < 16 * 8 * CTW; e += 32) {
        const int r = e / (8 * CTW), c = 8 * ct0 + e % (8 * CTW);
        if (r < nrw && c < c_in) dst[r * c_in + c] = y[(pr0 + r) * CS + c];
      }
    }
  };

  if (blockIdx.x < tiles) {
    stage_x(xb, blockIdx.x, rows_of(blockIdx.x));
    const int skew = copy_dd(blockIdx.x);
    probav::cp_async_commit();
    probav::cp_async_wait_all();
    __syncwarp();
    repack(dbt, skew, rows_of(blockIdx.x));
  }
  // Tile k of this block in buffers k % 2; its phase C and epilogue run in
  // step k + 1, the phase C interleaved with tile k + 1's phases A and B.
  int buf = 0;
  long prev = -1;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    __syncthreads();   // x, dd of this tile staged; dz^T of prev complete
    const long next = tile + gridDim.x;
    int skew = 0;
    if (next < tiles) {
      stage_x(xb + (buf ^ 1) * ROWS * CS, next, rows_of(next));
      skew = copy_dd(next);
    }
    probav::cp_async_commit();            // group: the next tile's x, dd
    stage_gy(gyb + buf * ROWS * CS, tile);
    probav::cp_async_commit();            // group: this tile's gy

    const E* xt = xb + buf * ROWS * CS;
    const E* dt = dbt + buf * ROWS * CS;
    E* zw = zt + buf * 256 * ZS;
#pragma unroll
    for (int t = 0; t < CTW; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 1
    for (int rg = 0; rg < RG; ++rg) {
      const int r0 = 16 * rg;
      // Phases A and B: this warp's j over rows r0 .. r0 + 15.  B of z^T
      // and W2 dd^T (K = c, N = 8 rows): plain, rows r0 + 8 nt; B of dW1^T
      // and dW2 (K = 16 rows, N = 8 c): .trans, c-tile pairs.
      uint32_t xf[2][4], df[2][4], xtr[2][4], dtr[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pl = (r0 + 8 * t + lane % 8) * CS + 8 * (lane / 8);
        ldsm_x4(xf[t], xt + pl);
        ldsm_x4(df[t], dt + pl);
        const int tr = (r0 + 8 * ((lane / 8) % 2) + lane % 8) * CS +
                       8 * (2 * t + lane / 16);
        ldsm_x4_trans(xtr[t], xt + tr);
        ldsm_x4_trans(dtr[t], dt + tr);
      }
      float z[MT][2][4], gg[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) z[mt][nt][i] = gg[mt][nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_bf16(z[mt][nt], wa[mt][ks], xf[nt][2 * ks],
                     xf[nt][2 * ks + 1]);
            mma_bf16(gg[mt][nt], wb[mt][ks], df[nt][2 * ks],
                     df[nt][2 * ks + 1]);
          }
        }
      // The previous tile's phase C, KPG of its k-steps, beside these
      // products (at a block's first tile it reads what the other dz^T
      // buffer holds, and nothing of it is stored).
      phase_c(zt + (buf ^ 1) * 256 * ZS, rg * KPG, KPG);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // C tile (mt, nt): j = J0 + 16 mt + g + 8 hh at registers 2 hh
        // and 2 hh + 1, rows r0 + 8 nt + 2q and + 1: dz = bf16(W2 dd)
        // masked by z > 0, h = bf16(relu(z)), as bf16x2 words.
        uint32_t adz[4], ah[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float z0 = z[mt][nt][2 * hh] + bias[mt][hh];
            const float z1 = z[mt][nt][2 * hh + 1] + bias[mt][hh];
            const uint32_t dzp =
                pack_bf16(gg[mt][nt][2 * hh], gg[mt][nt][2 * hh + 1]) &
                ((z0 > 0.f ? 0xffffu : 0u) | (z1 > 0.f ? 0xffff0000u : 0u));
            adz[2 * nt + hh] = dzp;
            ah[2 * nt + hh] = relu_bf16x2(z0, z1);
            db1a[mt][hh] += __uint_as_float(dzp << 16) +
                            __uint_as_float(dzp & 0xffff0000u);
            E* zp = zw + (J0 + 16 * mt + g + 8 * hh) * ZS;
            *reinterpret_cast<uint32_t*>(zp + r0 + 8 * nt + 2 * q) = dzp;
          }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(acc1[mt][2 * t], adz, xtr[t][0], xtr[t][1]);
          mma_bf16(acc1[mt][2 * t + 1], adz, xtr[t][2], xtr[t][3]);
          mma_bf16(acc2[mt][2 * t], ah, dtr[t][0], dtr[t][1]);
          mma_bf16(acc2[mt][2 * t + 1], ah, dtr[t][2], dtr[t][3]);
        }
      }
      // db2: dd at rows r0 + 2q (+1, +8, +9), c = 8 ct + g; row group rg
      // is summed by warp rg mod the warps.
      const float on = rg % SBB_WARPS == warp ? 1.f : 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dtr[t][i]));
          db2a[2 * t + i / 2] = fmaf(on, v.x + v.y, db2a[2 * t + i / 2]);
        }
    }
    if (prev >= 0) {
      probav::cp_async_wait_group<2>();   // prev's gy
      __syncwarp();
      epilogue(gyb + (buf ^ 1) * ROWS * CS, prev);
    }
    if (next < tiles) {
      probav::cp_async_wait_group<1>();   // the next tile's x, dd
      __syncwarp();
      repack(dbt + (buf ^ 1) * ROWS * CS, skew, rows_of(next));
    }
    prev = tile;
  }
  if (prev >= 0) {   // the last tile's phase C and epilogue
    __syncthreads();   // its dz^T complete
#pragma unroll
    for (int t = 0; t < CTW; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 1
    for (int rg = 0; rg < RG; ++rg)
      phase_c(zt + (buf ^ 1) * 256 * ZS, rg * KPG, KPG);
    probav::cp_async_wait_group<0>();
    __syncwarp();
    epilogue(gyb + (buf ^ 1) * ROWS * CS, prev);
  }
  probav::cp_async_wait_all();

  // Write this block's partial slot, every entry of dW1..dbc: dW1, then
  // dW2, staged in the dz^T space in the slot's order and stored in
  // coalesced runs.
  const Slot sl(c_in, c_mid, c_dec);
  float* slot = part + blockIdx.x * slot_len;
  float* sbuf = reinterpret_cast<float*>(zt);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();   // the dz^T space (then sbuf) read
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = J0 + 16 * mt + g + 8 * (i / 2);
          const int c = 8 * ct + 2 * q + (i & 1);
          if (pass == 0 && j < c_mid && c < c_in)
            sbuf[c * c_mid + j] = acc1[mt][ct][i];
          if (pass == 1 && j < c_mid && c < c_dec)
            sbuf[j * c_dec + c] = acc2[mt][ct][i];
        }
    __syncthreads();
    const int len = pass == 0 ? c_in * c_mid : c_mid * c_dec;
    float* dst = slot + (pass == 0 ? sl.w1 : sl.w2);
    for (int e = tid; e < len; e += blockDim.x) dst[e] = sbuf[e];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // db1: lanes q hold rows 2q, 2q + 1 (mod 8) of j; summed in order.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = db1a[mt][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int j = J0 + 16 * mt + g + 8 * hh;
      if (q == 0 && j < c_mid) slot[sl.b1 + j] = v;
    }
  }
#pragma unroll
  for (int ct = 0; ct < 4; ++ct) {   // db2 of this warp's row groups
    float v = db2a[ct];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0) red[(SBB_WARPS + warp) * 32 + 8 * ct + g] = v;
  }
  // dbc: sum the 8 row groups (lanes g) of each warp, then the warps.
#pragma unroll
  for (int t = 0; t < CTW; ++t)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v = dbca[t][u];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * 32 + 8 * (ct0 + t) + 2 * q + u] = v;
    }
  __syncthreads();
  if (tid < c_in) {
    float sum = 0.f;
    for (int w = 0; w < SBB_WARPS; ++w) sum += red[w * 32 + tid];
    slot[sl.bc + tid] = sum;
  }
  if (tid < c_dec) {
    float sum = 0.f;
    for (int w = 0; w < SBB_WARPS; ++w) sum += red[(SBB_WARPS + w) * 32 + tid];
    slot[sl.b2 + tid] = sum;
  }
}

cudaError_t launch_seg_bwd_bf16(const void* x, const void* dd, const void* gy,
                                const void* w1, const float* b1,
                                const void* w2, void* dx, float* part,
                                long slot_len, int G, int n, int c_in,
                                int c_mid, int c_dec, cudaStream_t s) {
  const size_t smem = seg_bwd_bf16_smem();
  auto kern = seg_bwd_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using B16 = __nv_bfloat16;
  kern<<<G, SBB_WARPS * 32, smem, s>>>(
      static_cast<const B16*>(x), static_cast<const B16*>(dd),
      static_cast<const B16*>(gy), static_cast<const B16*>(w1), b1,
      static_cast<const B16*>(w2), static_cast<B16*>(dx), part, slot_len, n,
      c_in, c_mid, c_dec);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// seg_bwd, bf16 on the tensor cores beyond the flagship's widths, up to     //
// c_in, c_dec <= 64 and c_mid <= 512 (the 0.9411 model's 64/512/51, the    //
// 48-filter model's 48/384/38): seg_bwd_split_kernel, then dx_sum_kernel.  //
// Together they compute what seg_bwd_bf16_kernel computes, into the same   //
// slot layout, with the same rounding points.                             //
// ------------------------------------------------------------------------ //
//
// - Why a split.  seg_bwd_bf16_kernel keeps each warp's dW1^T and dW2 sums
//   (32 j x 32 c of each) and its W1^T and W2 A fragments in registers for
//   the block's life, and all 256 middle channels j of a row in one block.
//   At 64/512/51 that is four times the sums (~61k float32 a block against
//   a 64k register file) and W1 alone takes [512][72] bf16 of shared
//   memory.  dx = W1 dz + gy needs every j of a row, the weight sums every
//   row of a j.  So C_mid is cut into chunks of SBS_JC = 256 j, one chunk a
//   block: block b of G x chunks takes chunk b % chunks of the row tiles of
//   slot b / chunks (a slot's chunks adjacent, so they run together and
//   read x and dd from L2 but once from memory), sums its chunk's dW1, dW2
//   and db1 over those rows in registers, and writes dx's part from its
//   chunk, dz W1^T over 256 j, as float32 rows of dxp[chunk][n][ldp] (ldp:
//   c_in rounded up to 8).  dx_sum_kernel then adds the chunks' parts in
//   order and gy in float32, rounds to bf16 and sums gy into dbc: dx is
//   rounded once, after every product, as in the plain version.
// - Per block, the flagship kernel's products at twice its channels: warp
//   w of 8 owns j = 32 w .. 32 w + 31 of the chunk; per 16 rows z^T = W1^T
//   x^T + b1 and W2 dd^T come out of the mma as 16 j x 8 row C tiles over
//   K = 64 channels (four k-steps), dz^T = relu'(z) (W2 dd) and h^T =
//   relu(z) are rounded to bf16 in registers, and two C tiles adjacent in
//   rows are the A fragment of dW1^T += dz^T x and dW2 += h^T dd (K = the
//   16 rows, eight 8-channel n-tiles).  The sums, 2 x 2 x 8 tiles of 4
//   float32 (128 a lane), stay in registers; the A fragments of W1^T and W2
//   do not fit beside them and are loaded by ldmatrix per k-step from the
//   chunk's [j][72] planes of W1 and W2 (stride 144 bytes: the 8 rows of an
//   ldmatrix in distinct banks), and the B fragments of dW1^T and dW2 once
//   per 16 rows for both m-tiles.
// - Phase C, dx's part: dz^T goes to shared memory ([j][row], stride
//   ROWS + 8 = 72: each dz^T word store and each ldmatrix conflict-free);
//   after a barrier warp w computes rows 16 (w % 4) .. + 15 by channels
//   32 (w / 4) .. + 31 over the chunk's 256 j (A = dz from dz^T and B = W1^T
//   from the W1 plane, both by ldmatrix.trans) and stores them as float2.
// - Staging: 64-row tiles of x, double-buffered by 16-byte cp.async into
//   [row][72] (zeros past n and from c_in); warp w copies its 8 rows of
//   the next tile's dd, one contiguous span of 8 c_dec elements, into its
//   own raw buffer (16-byte cp.async from the chunk below its start) and
//   repacks it into [row][72], zeros past c_dec and past n, guarded by
//   __syncwarp alone.  Two barriers a tile: before the products (the tile
//   staged, the last phase C done with dz^T) and before phase C.
// - Sums: db1 sums dz^T's C fragments per lane, db2 dd's .trans B
//   fragments (warp w those of row group w), reduced over lanes and warps
//   in a fixed order; the chunk-0 block of a slot writes db2.  dW1 and dW2
//   are staged in the W planes' space in the slot's order and stored in
//   runs.  No atomics: every entry of a slot has one writer.
// - Zeros past n: x rows are zero-filled and dd rows repacked as zeros, so
//   rows past n add nothing (h there is relu(b1), against dd = 0); their dx
//   parts are not stored.
//
// What bounds it on an H100 at the 64-filter model's train step (N =
// 557,568, 64/512/51): 2 N c_mid (3 c_in + 2 c_dec) = 167.9 GFLOP (0.170
// ms at the 989 TFLOP/s bf16 peak; the mma issue 182.7 GFLOP at c_dec
// padded to 64) against 199.6 MB of x, dd, gy read and dx written (0.060
// ms): operations.  The split adds dx's float32 parts, written and read
// once each: 2 x 2 x N x 64 x 4 = 571 MB (0.170 ms at 3.35 TB/s), where
// the flagship kernel keeps dz in its block.  One block of 8 warps an SM:
// 157,952 bytes of shared memory (the W1 and W2 planes [256][72], dz^T
// [256][72], two each of the x and dd tiles [64][72], the warps' raw dd
// spans, the db2 sums).

constexpr int SBS_WARPS = 8;     // each owns SBS_JC / SBS_WARPS = 32 j
constexpr int SBS_ROWS = 64;     // rows per tile
constexpr int SBS_JC = 256;      // middle channels a block: its chunk
constexpr int SBS_CH = 64;       // c_in, c_dec it takes (zero-padded)
constexpr int SBS_CS = SBS_CH + 8;     // bf16 row stride: x, dd, W1, W2
constexpr int SBS_ZS = SBS_ROWS + 8;   // dz^T [j][row] row stride
constexpr int SBS_DR = SBS_ROWS / SBS_WARPS;   // dd rows a warp copies
constexpr int SBS_RAWW = (SBS_DR * SBS_CH * 2 + 43) / 16 * 8;   // elements

int seg_bwd_split_chunks(int c_mid) { return (c_mid + SBS_JC - 1) / SBS_JC; }

// Floats of a row of dx's float32 parts.
int seg_bwd_split_ldp(int c_in) { return (c_in + 7) / 8 * 8; }

size_t seg_bwd_split_smem() {
  return sizeof(__nv_bfloat16) *
             ((size_t)SBS_JC * (2 * SBS_CS + SBS_ZS) +
              4 * SBS_ROWS * SBS_CS + SBS_WARPS * SBS_RAWW) +
         sizeof(float) * SBS_WARPS * SBS_CH;
}

__global__ void __launch_bounds__(SBS_WARPS * 32, 1)
seg_bwd_split_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ dd,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     float* __restrict__ dxp, int ldp,
                     float* __restrict__ part, long slot_len, int chunks,
                     int n, int c_in, int c_mid, int c_dec) {
  using E = __nv_bfloat16;
  using probav::ldsm_x4;
  using probav::ldsm_x4_trans;
  using probav::mma_bf16;
  using probav::pack2;
  using probav::pack_bf16;
  using probav::relu_bf16x2;
  constexpr int ROWS = SBS_ROWS, CS = SBS_CS, ZS = SBS_ZS, JC = SBS_JC;
  constexpr int RG = ROWS / 16;                // 16-row groups a tile
  static_assert(JC == 32 * SBS_WARPS, "32 j a warp");
  static_assert(2 * RG == SBS_WARPS, "phase C: 4 row groups x 2 halves");
  static_assert(JC * CS * 2 * 2 >= JC * SBS_CH * 4,
                "dW1, dW2 staged in the W planes' space");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* w1s = reinterpret_cast<E*>(smem_raw);   // [JC][CS]  w1[c][j0 + j]
  E* w2s = w1s + JC * CS;                    // [JC][CS]  w2[j0 + j][c]
  E* zt = w2s + JC * CS;                     // [JC][ZS]  dz^T of a tile
  E* xb = zt + JC * ZS;                      // [2][ROWS][CS]  x tiles
  E* dbt = xb + 2 * ROWS * CS;               // [2][ROWS][CS]  dd tiles
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  E* raw = dbt + 2 * ROWS * CS + warp * SBS_RAWW;   // this warp's dd span
  float* red = reinterpret_cast<float*>(dbt + 2 * ROWS * CS +
                                        SBS_WARPS * SBS_RAWW);   // [W][64]
  const E zero = __float2bfloat16_rn(0.f);
  const int g = lane / 4, q = lane % 4;
  const int chunk = (int)(blockIdx.x % chunks);
  const int slot_i = (int)(blockIdx.x / chunks);
  const int G = (int)(gridDim.x / chunks);   // slots: row-tile strides
  const int j0 = chunk * JC;                 // the chunk's first j
  const int J0 = 32 * warp;                  // this warp's j in the chunk
  const int pr0 = 16 * (warp % RG);          // its phase-C rows
  const int ct0 = 4 * (warp / RG);           // and 8-column tiles of dx
  const int dr0 = SBS_DR * warp;             // its dd rows of a tile

  // The chunk's W1 and W2 as [j][c], zero-padded to JC x 64 (padded z, dz,
  // h are 0); the tiles zeroed once (the copies never write x's columns
  // from c_in on).
  for (int e = tid; e < JC * SBS_CH; e += blockDim.x) {
    const int c = e / JC, j = e % JC;
    w1s[j * CS + c] = (c < c_in && j0 + j < c_mid)
                          ? w1[(long)c * c_mid + j0 + j] : zero;
    const int j2 = e / SBS_CH, c2 = e % SBS_CH;
    w2s[j2 * CS + c2] = (j0 + j2 < c_mid && c2 < c_dec)
                            ? w2[(long)(j0 + j2) * c_dec + c2] : zero;
  }
  for (int e = tid; e < 4 * ROWS * CS / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(xb)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();   // the zeros land before any copy into the tiles
  float bias[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + J0 + 16 * mt + g + 8 * hh;
      bias[mt][hh] = j < c_mid ? b1[j] : 0.f;
    }

  float acc1[2][8][4], acc2[2][8][4];   // dW1^T (j, c), dW2 (j, c) tiles
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ct = 0; ct < 8; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][ct][i] = acc2[mt][ct][i] = 0.f;
  float db1a[2][2] = {}, db2a[8] = {};

  const bool vec = c_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  auto rows_of = [&](long t) {
    return (int)min((long)ROWS, (long)n - t * ROWS);
  };
  // Rows [0, nr) of x from tile t into dst (zeros past nr), block-wide:
  // 16-byte cp.async where `vec`, else plain copies.
  auto stage_x = [&](E* dst, long t, int nr) {
    const E* src = x + t * ROWS * c_in;
    if (vec) {
      const int c8 = c_in / 8;
      for (int e = tid; e < ROWS * c8; e += blockDim.x) {
        const int r = e / c8, c = 8 * (e % c8);
        const bool in = r < nr;
        probav::cp_async16_zfill(dst + r * CS + c,
                                 in ? src + r * c_in + c : src, in);
      }
    } else {
      for (int e = tid; e < ROWS * c_in; e += blockDim.x) {
        const int r = e / c_in, c = e % c_in;
        dst[r * CS + c] = r < nr ? src[r * c_in + c] : zero;
      }
    }
  };
  // This warp's SBS_DR rows of dd from tile t: the span of its real rows,
  // by 16-byte cp.async from the chunk below its start; returns the
  // element offset of the span in raw.
  auto copy_dd = [&](long t) {
    const int nrw = min(SBS_DR, rows_of(t) - dr0);
    if (nrw <= 0) return 0;
    const uintptr_t s = reinterpret_cast<uintptr_t>(
        dd + (t * ROWS + dr0) * c_dec);
    const uintptr_t a = s & ~uintptr_t(15);
    const int chunks16 =
        (int)((s + 2 * (uintptr_t)(nrw * c_dec) + 15 - a) / 16);
    for (int i = lane; i < chunks16; i += 32)
      probav::cp_async16(raw + 8 * i, a + 16 * (uintptr_t)i);
    return (int)((s - a) / 2);
  };
  // ... and its repack into rows dr0 .. dr0 + SBS_DR - 1 of a dd tile: 8
  // channels a step, zeros from c_dec and past the tile's nr rows.
  auto repack = [&](E* dst, int skew, int nr) {
    const E* src = raw + skew;
    for (int u = lane; u < SBS_DR * 8; u += 32) {
      const int p = u / 8, j = u % 8;
      const E* s = src + p * c_dec + 8 * j;
      const bool in = dr0 + p < nr;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 8 * j + 2 * k;
        v[k] = pack2(in && c < c_dec ? s[2 * k] : zero,
                     in && c + 1 < c_dec ? s[2 * k + 1] : zero);
      }
      *reinterpret_cast<uint4*>(dst + (dr0 + p) * CS + 8 * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  if (slot_i < tiles) {
    stage_x(xb, slot_i, rows_of(slot_i));
    const int skew = copy_dd(slot_i);
    probav::cp_async_commit();
    probav::cp_async_wait_all();
    __syncwarp();
    repack(dbt, skew, rows_of(slot_i));
  }
  // Phase C's lane addresses: A = dz (rows pr0.., 16 j a step) from dz^T,
  // B = W1^T (16 j, this warp's c-tiles) from the W1 plane.
  const int zoff = (8 * (lane / 16) + lane % 8) * ZS + pr0 +
                   8 * ((lane / 8) % 2);
  const E* wp = w1s + (8 * ((lane / 8) % 2) + lane % 8) * CS +
                8 * (ct0 + lane / 16);
  float* dxc_dst = dxp + (long)chunk * n * ldp;
  int buf = 0;
  for (long tile = slot_i; tile < tiles; tile += G, buf ^= 1) {
    __syncthreads();   // x, dd of this tile staged; dz^T free
    const long next = tile + G;
    int skew = 0;
    if (next < tiles) {
      stage_x(xb + (buf ^ 1) * ROWS * CS, next, rows_of(next));
      skew = copy_dd(next);
    }
    probav::cp_async_commit();   // group: the next tile's x, dd

    const E* xt = xb + buf * ROWS * CS;
    const E* dt = dbt + buf * ROWS * CS;
#pragma unroll 1
    for (int rg = 0; rg < RG; ++rg) {
      const int r0 = 16 * rg;
      // B of z^T and W2 dd^T (K = 64 c in two halves, N = 8 rows): plain
      // ldmatrix of rows r0 + 8 nt.
      uint32_t xf[2][2][4], df[2][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const int pl = (r0 + 8 * nt + lane % 8) * CS + 32 * kp +
                         8 * (lane / 8);
          ldsm_x4(xf[nt][kp], xt + pl);
          ldsm_x4(df[nt][kp], dt + pl);
        }
      uint32_t adz[2][4], ah[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float z[2][4], gg[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) z[nt][i] = gg[nt][i] = 0.f;
        const E* arow = w1s + (J0 + 16 * mt + 8 * ((lane / 8) % 2) +
                               lane % 8) * CS + 8 * (lane / 16);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t wa[4], wb[4];
          ldsm_x4(wa, arow + 16 * ks);
          ldsm_x4(wb, arow + JC * CS + 16 * ks);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_bf16(z[nt], wa, xf[nt][ks / 2][2 * (ks % 2)],
                     xf[nt][ks / 2][2 * (ks % 2) + 1]);
            mma_bf16(gg[nt], wb, df[nt][ks / 2][2 * (ks % 2)],
                     df[nt][ks / 2][2 * (ks % 2) + 1]);
          }
        }
        // C tile (mt, nt): j = J0 + 16 mt + g + 8 hh at registers 2 hh and
        // 2 hh + 1, rows r0 + 8 nt + 2q and + 1: dz = bf16(W2 dd) masked by
        // z > 0, h = bf16(relu(z)), as bf16x2 words.
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float z0 = z[nt][2 * hh] + bias[mt][hh];
            const float z1 = z[nt][2 * hh + 1] + bias[mt][hh];
            const uint32_t dzp =
                pack_bf16(gg[nt][2 * hh], gg[nt][2 * hh + 1]) &
                ((z0 > 0.f ? 0xffffu : 0u) | (z1 > 0.f ? 0xffff0000u : 0u));
            adz[mt][2 * nt + hh] = dzp;
            ah[mt][2 * nt + hh] = relu_bf16x2(z0, z1);
            db1a[mt][hh] += __uint_as_float(dzp << 16) +
                            __uint_as_float(dzp & 0xffff0000u);
            *reinterpret_cast<uint32_t*>(
                zt + (J0 + 16 * mt + g + 8 * hh) * ZS + r0 + 8 * nt +
                2 * q) = dzp;
          }
      }
      // dW1^T += dz^T x and dW2 += h^T dd: B (K = 16 rows, N = 8 c) by
      // ldmatrix.trans, c-tile pairs, each for both m-tiles.  db2: dd at
      // rows r0 + 2q (+1, +8, +9), c = 8 ct + g; row group rg is summed by
      // warp rg.
      const float on = rg == warp ? 1.f : 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t xtr[4], dtr[4];
        const int tr = (r0 + 8 * ((lane / 8) % 2) + lane % 8) * CS +
                       16 * p + 8 * (lane / 16);
        ldsm_x4_trans(xtr, xt + tr);
        ldsm_x4_trans(dtr, dt + tr);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc1[mt][2 * p], adz[mt], xtr[0], xtr[1]);
          mma_bf16(acc1[mt][2 * p + 1], adz[mt], xtr[2], xtr[3]);
          mma_bf16(acc2[mt][2 * p], ah[mt], dtr[0], dtr[1]);
          mma_bf16(acc2[mt][2 * p + 1], ah[mt], dtr[2], dtr[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dtr[i]));
          db2a[2 * p + i / 2] = fmaf(on, v.x + v.y, db2a[2 * p + i / 2]);
        }
      }
    }
    __syncthreads();   // dz^T of the tile complete

    // Phase C: dx's part from this chunk for rows pr0 .. pr0 + 15 and this
    // warp's four c-tiles, over the chunk's 256 j.
    float dxc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < JC / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4_trans(a, zt + zoff + ks * 16 * ZS);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(b, wp + ks * 16 * CS + 16 * p);
        mma_bf16(dxc[2 * p], a, b[0], b[1]);
        mma_bf16(dxc[2 * p + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long row = tile * ROWS + pr0 + g + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = 8 * (ct0 + t) + 2 * q;
        if (c < ldp)
          *reinterpret_cast<float2*>(dxc_dst + row * ldp + c) =
              make_float2(dxc[t][2 * hh], dxc[t][2 * hh + 1]);
      }
    }
    if (next < tiles) {
      probav::cp_async_wait_all();
      __syncwarp();
      repack(dbt + (buf ^ 1) * ROWS * CS, skew, rows_of(next));
    }
  }
  probav::cp_async_wait_all();

  // Write this block's part of its slot: dW1 [c][j0..], dW2 [j0..][c]
  // (staged in the W planes' space in the slot's order, stored in runs),
  // db1 [j0..], and from the chunk-0 block db2.
  const Slot sl(c_in, c_mid, c_dec);
  float* slot = part + slot_i * slot_len;
  float* sbuf = reinterpret_cast<float*>(smem_raw);
  const int jn = min(JC, c_mid - j0);   // the chunk's real j
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();   // the W planes (then sbuf) read
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ct = 0; ct < 8; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = J0 + 16 * mt + g + 8 * (i / 2);
          const int c = 8 * ct + 2 * q + (i & 1);
          if (pass == 0 && j < jn && c < c_in)
            sbuf[c * JC + j] = acc1[mt][ct][i];
          if (pass == 1 && j < jn && c < c_dec)
            sbuf[j * c_dec + c] = acc2[mt][ct][i];
        }
    __syncthreads();
    if (pass == 0) {
      for (int e = tid; e < c_in * JC; e += blockDim.x) {
        const int c = e / JC, j = e % JC;
        if (j < jn) slot[sl.w1 + (long)c * c_mid + j0 + j] = sbuf[e];
      }
    } else {
      for (int e = tid; e < jn * c_dec; e += blockDim.x)
        slot[sl.w2 + (long)j0 * c_dec + e] = sbuf[e];
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // db1: lanes q hold rows 2q, 2q + 1 (mod 8) of j; summed in order.
      float v = db1a[mt][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int j = J0 + 16 * mt + g + 8 * hh;
      if (q == 0 && j < jn) slot[sl.b1 + j0 + j] = v;
    }
  if (chunk == 0) {
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {   // db2 of this warp's row groups
      float v = db2a[ct];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) red[warp * SBS_CH + 8 * ct + g] = v;
    }
    __syncthreads();
    if (tid < c_dec) {
      float sum = 0.f;
      for (int w = 0; w < SBS_WARPS; ++w) sum += red[w * SBS_CH + tid];
      slot[sl.b2 + tid] = sum;
    }
  }
}

// dx = T(sum over the chunks of dxp + gy) and dbc = sum of gy, after
// seg_bwd_split_kernel (T bf16) or seg_bwd_tf32_split_kernel (T float):
// block b of G sums the rows [b per, (b + 1) per), thread t the four
// channels 4 (t % 16) .. of rows t / 16 + 16 k, and writes dbc into slot
// b; the chunks added in order, then gy, in float32, dx rounded once.
// VEC: c_in a multiple of 4 and gy, dx aligned to four elements (one load
// or store of four).  Memory-bound: chunks x N x ldp x 4 bytes of parts
// and N x c_in elements of gy read, N x c_in of dx written; unrolled so
// that each thread keeps several rows' loads in flight.
constexpr int DXS_THREADS = 256;

// Four elements of gy as float32, and four float32 sums stored as dx.
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&g)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  g[0] = a.x; g[1] = a.y; g[2] = b.x; g[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float (&g)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(probav::pack_bf16(v[0], v[1]), probav::pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(DXS_THREADS)
dx_sum_kernel(const float* __restrict__ dxp, int chunks, int ldp,
              const T* __restrict__ gy, T* __restrict__ dx,
              float* __restrict__ part, long slot_len, long bc, int n,
              int c_in) {
  __shared__ float red[DXS_THREADS / 16][64];
  const int tid = threadIdx.x, c = 4 * (tid % 16), rl = tid / 16;
  const long per = ((long)n + gridDim.x - 1) / gridDim.x;
  const long r0 = min((long)n, (long)blockIdx.x * per);
  const long r1 = min((long)n, r0 + per);
  const long ps = (long)n * ldp;   // floats from one chunk's parts to the next
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < c_in) {
#pragma unroll 4
    for (long r = r0 + rl; r < r1; r += DXS_THREADS / 16) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < chunks; ++k) {
        const float4 p =
            *reinterpret_cast<const float4*>(dxp + k * ps + r * ldp + c);
        v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
      }
      const long e = r * c_in + c;
      if constexpr (VEC) {
        float g[4];
        load4(gy + e, g);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u] += g[u];
          v[u] += g[u];
        }
        store4(dx + e, v);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < c_in) {
            const float gv = to_f(gy[e + u]);
            acc[u] += gv;
            dx[e + u] = from_f<T>(v[u] + gv);
          }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) red[rl][c + u] = acc[u];
  __syncthreads();
  if (tid < c_in) {
    float sum = 0.f;
    for (int l = 0; l < DXS_THREADS / 16; ++l) sum += red[l][tid];
    part[blockIdx.x * slot_len + bc + tid] = sum;
  }
}

// dx_sum_kernel over G blocks, VEC where c_in and the pointers allow.
template <typename T>
cudaError_t launch_dx_sum(const float* dxp, int chunks, int ldp, const T* gy,
                          T* dx, float* part, long slot_len, int G, int n,
                          int c_in, long bc, cudaStream_t s) {
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = c_in % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(gy) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % align == 0;
  auto sum = vec ? dx_sum_kernel<T, true> : dx_sum_kernel<T, false>;
  sum<<<G, DXS_THREADS, 0, s>>>(dxp, chunks, ldp, gy, dx, part, slot_len, bc,
                                n, c_in);
  return cudaGetLastError();
}

cudaError_t launch_seg_bwd_split(const void* x, const void* dd,
                                 const void* gy, const void* w1,
                                 const float* b1, const void* w2, void* dx,
                                 float* dxp, float* part, long slot_len,
                                 int G, int n, int c_in, int c_mid,
                                 int c_dec, cudaStream_t s) {
  if (dxp == nullptr) return cudaErrorInvalidValue;
  using B16 = __nv_bfloat16;
  const int chunks = seg_bwd_split_chunks(c_mid);
  const int ldp = seg_bwd_split_ldp(c_in);
  const size_t smem = seg_bwd_split_smem();
  auto kern = seg_bwd_split_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G * chunks, SBS_WARPS * 32, smem, s>>>(
      static_cast<const B16*>(x), static_cast<const B16*>(dd),
      static_cast<const B16*>(w1), b1, static_cast<const B16*>(w2), dxp, ldp,
      part, slot_len, chunks, n, c_in, c_mid, c_dec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dx_sum(dxp, chunks, ldp, static_cast<const B16*>(gy),
                       static_cast<B16*>(dx), part, slot_len, G, n, c_in,
                       Slot(c_in, c_mid, c_dec).bc, s);
}

// ------------------------------------------------------------------------ //
// seg_bwd, float32 on the tensor cores as 3xTF32 (mma.sync.m16n8k8, float32 //
// sums; split_tf32 in common.cuh), for c_in, c_dec <= 32 and c_mid <= 256   //
// (the flagship's 32/256/25).  It computes what seg_bwd_kernel<float, ...,  //
// false> computes, with the same slot layout and no rounding point.  Its    //
// WIDE flavour, wide_bwd_tf32_kernel, is the float32 wide_bwd (replacing    //
// the TPU kernel _bwd of probav_tpu/ops/pallas_wide_block.py:110): what     //
// seg_bwd_kernel<float, ..., true> computes, with dy in dd's place, no gy   //
// (dx = W1 dz), no dbc, the slot without dWc and dbc, and one wave of      //
// min(G, resident) blocks, the other slots zeroed by a memset.  Both share  //
// one body, seg_bwd_tf32_body<WIDE>.                                        //
//                                                                          //
// Bound at the flagship (N = 557,568): 2 N c_mid (3 c_in + 2 c_dec) = 41.7  //
// GFLOP, three TF32 products each, 0.253 ms at the 494.7 TFLOP/s TF32 peak  //
// (0.62 ms at the 67 TFLOP/s of the CUDA cores), against 270 MB moved      //
// (0.081 ms): operations.                                                  //
//                                                                          //
// A tile is 128 rows, and c_mid is taken in chunks of 64 middle channels;  //
// each of the 8 warps owns 16 rows of the tile in phase A:                 //
// - Phase A, per pair of 8-column n-tiles: z = x W1 + b1 and W2 dd come    //
//   out of the mma in the C layout; dz = relu'(z) (W2 dd) and h = relu(z)  //
//   go to shared memory ([row][j], float2 stores) and, without shuffles,   //
//   into dx += dz W1^T: a TF32 A fragment takes columns q and q+4, so C's  //
//   columns 2q and 2q+1 are fed as A's q and q+4 and the B rows of W1^T    //
//   are read with the same permutation (the order of k inside a dot       //
//   product is free).  x and dd A fragments are split once per tile.       //
// - Phase B, block-wide: dW1 += x^T dz and dW2 += h^T dd over the tile's   //
//   128 rows (K), each warp one 32x8 tile of dW1 and one 16x16 tile of dW2 //
//   of the chunk; db1 and db2 from the B fragments it loads anyway.        //
// Every fragment is one float32 word, so x, dd, dz and h stay row-major   //
// in shared memory and no tile is transposed; the strides (40 for x, dd;  //
// 72 for dz, h; 264 for the weights) make every fragment read of phase B   //
// and the weight reads conflict-free (phase A's once-a-tile x/dd reads     //
// 2-way).  The tensor cores sum with truncation, so each chunk's dx        //
// products and each chunk's weight-gradient products over one tile go to  //
// fresh accumulators, added in float32 to the running sums (dx over the    //
// chunks, dW1/dW2 over all the block's tiles, in registers, written to the //
// slot once).  x and dd tiles are double-buffered: the next tile's rows    //
// arrive by cp.async (16 bytes where a row is a multiple of 4 floats, else //
// 4) while this one computes.  The weights are staged once per block and   //
// split at each load: their hi/lo planes would not fit beside the tiles.   //
// Shared memory: 2 x 33,792 (w1, w2 as [c][j]) + 1,024 (b1) + 2 x 36,864  //
// (dz, h) + 4 x 20,480 (x, dd, two buffers) + 1,024 (dbc): 225,280 B      //
// (WIDE 224,256 B), one block per SM.                                      //
// ------------------------------------------------------------------------ //

constexpr int SBT_ROWS = 128;            // rows per tile
constexpr int SBT_WARPS = 8;             // 16 rows each in phase A
constexpr int SBT_CH = 64;               // middle channels per chunk
constexpr int SBT_NCH = 4;               // chunks: c_mid <= 256
constexpr int SBT_XS = 40;               // x / dd row stride (floats)
constexpr int SBT_ZS = SBT_CH + 8;       // dz / h row stride
constexpr int SBT_WS = 256 + 8;          // [c][j] weight row stride

// The body of seg_bwd_tf32_kernel (WIDE false) and of wide_bwd_tf32_kernel
// (WIDE true: dd is dy, gy is not read, dx = W1 dz, no dbc, and the slot
// has no dWc and no dbc).
template <bool WIDE>
__device__ __forceinline__ void seg_bwd_tf32_body(
    const float* __restrict__ x, const float* __restrict__ dd,
    const float* __restrict__ gy, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    float* __restrict__ dx, float* __restrict__ part, long slot_len, int n,
    int c_in, int c_mid, int c_dec) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                            // [32][WS]  w1[c][j]
  float* w2s = w1s + 32 * SBT_WS;               // [32][WS]  w2[j][c] at [c][j]
  float* b1s = w2s + 32 * SBT_WS;               // [256]
  float* zs = b1s + 256;                        // [ROWS][ZS]  dz of a chunk
  float* hs = zs + SBT_ROWS * SBT_ZS;           // [ROWS][ZS]  h of a chunk
  float* xb = hs + SBT_ROWS * SBT_ZS;           // [2][ROWS][XS]  x tiles
  float* db = xb + 2 * SBT_ROWS * SBT_XS;       // [2][ROWS][XS]  dd tiles
  float* red = db + 2 * SBT_ROWS * SBT_XS;      // [WARPS][32]  dbc
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;

  // Weights zero-padded to 32 x 256 (padded z, dz and h are 0); the tile
  // buffers zeroed once: the copies never write their padding columns.
  for (int e = tid; e < 32 * 256; e += blockDim.x) {
    const int c = e / 256, j = e % 256;
    w1s[c * SBT_WS + j] = (c < c_in && j < c_mid) ? w1[(long)c * c_mid + j]
                                                  : 0.f;
    const int j2 = e / 32, c2 = e % 32;
    w2s[c2 * SBT_WS + j2] =
        (c2 < c_dec && j2 < c_mid) ? w2[(long)j2 * c_dec + c2] : 0.f;
  }
  for (int j = tid; j < 256; j += blockDim.x) b1s[j] = j < c_mid ? b1[j] : 0.f;
  for (int e = tid; e < 4 * SBT_ROWS * SBT_XS; e += blockDim.x) xb[e] = 0.f;
  __syncthreads();

  const bool xvec = c_in % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool dvec = c_dec % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  const long tiles = ((long)n + SBT_ROWS - 1) / SBT_ROWS;
  auto stage = [&](long tile, int buf) {
    const long row0 = tile * SBT_ROWS;
    const int nrows = (int)min((long)SBT_ROWS, (long)n - row0);
    copy_rows<SBT_ROWS, SBT_XS>(xb + buf * SBT_ROWS * SBT_XS, x + row0 * c_in,
                                nrows, c_in, xvec);
    copy_rows<SBT_ROWS, SBT_XS>(db + buf * SBT_ROWS * SBT_XS,
                                dd + row0 * c_dec, nrows, c_dec, dvec);
    probav::cp_async_commit();
  };

  float acc1[SBT_NCH][2][4], acc2[SBT_NCH][2][4];   // dW1, dW2 tiles
#pragma unroll
  for (int ch = 0; ch < SBT_NCH; ++ch)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[ch][t][i] = acc2[ch][t][i] = 0.f;
  float db1a[SBT_NCH] = {}, db2a[2] = {}, dbca[4][2] = {};

  const int rw = warp * 16;                // this warp's rows in phase A
  const int mh = (warp / 2) * 16;          // its dW2 rows (j) in a chunk
  const int nd = (warp % 2) * 16;          // its dW2 columns (c)
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  int buf = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    // The other buffer was last read before the previous tile's final
    // barrier.
    if (tile + gridDim.x < tiles) stage(tile + gridDim.x, buf ^ 1);
    else probav::cp_async_commit();
    probav::cp_async_wait_group<1>();
    __syncthreads();
    const float* xt = xb + buf * SBT_ROWS * SBT_XS;
    const float* dt = db + buf * SBT_ROWS * SBT_XS;
    const long row0 = tile * SBT_ROWS;
    const int nrows = (int)min((long)SBT_ROWS, (long)n - row0);

    // Phase A's A fragments of x and dd (rows rw + g, rw + g + 8), split.
    FragA ax[4], ad[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* X = xt + (rw + g) * SBT_XS + k * 8 + q;
      const float* D = dt + (rw + g) * SBT_XS + k * 8 + q;
      split_a(ax[k], X[0], X[8 * SBT_XS], X[4], X[8 * SBT_XS + 4]);
      split_a(ad[k], D[0], D[8 * SBT_XS], D[4], D[8 * SBT_XS + 4]);
    }
    float dxa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.f;

#pragma unroll
    for (int ch = 0; ch < SBT_NCH; ++ch) {
      const int j0 = ch * SBT_CH;
      if (j0 >= c_mid) break;              // uniform over the block
      float dxc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;

      // Phase A, two n-tiles (16 middle channels) at a time.
#pragma unroll 2
      for (int p = 0; p < SBT_CH / 16; ++p) {
        const int jn = j0 + p * 16;
        float z[2][4] = {}, gg[2][4] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          FragB bw[2], bv[2];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float* Wz = w1s + (k * 8 + q) * SBT_WS + jn + t * 8 + g;
            const float* Wg = w2s + (k * 8 + q) * SBT_WS + jn + t * 8 + g;
            split_b(bw[t], Wz[0], Wz[4 * SBT_WS]);
            split_b(bv[t], Wg[0], Wg[4 * SBT_WS]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              mma_term(z[t], ax[k], bw[t], term);
              mma_term(gg[t], ad[k], bv[t], term);
            }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int jl = p * 16 + t * 8 + 2 * q;   // chunk column of C's 2q
          const float bb0 = b1s[j0 + jl], bb1 = b1s[j0 + jl + 1];
          z[t][0] += bb0; z[t][1] += bb1; z[t][2] += bb0; z[t][3] += bb1;
          float dz[4], h[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dz[i] = z[t][i] > 0.f ? gg[t][i] : 0.f;
            h[i] = fmaxf(z[t][i], 0.f);
          }
          float* Z = zs + (rw + g) * SBT_ZS + jl;
          float* Hh = hs + (rw + g) * SBT_ZS + jl;
          *reinterpret_cast<float2*>(Z) = make_float2(dz[0], dz[1]);
          *reinterpret_cast<float2*>(Z + 8 * SBT_ZS) =
              make_float2(dz[2], dz[3]);
          *reinterpret_cast<float2*>(Hh) = make_float2(h[0], h[1]);
          *reinterpret_cast<float2*>(Hh + 8 * SBT_ZS) =
              make_float2(h[2], h[3]);
          // dx += dz W1^T over these 8 middle channels: C columns 2q, 2q+1
          // are A columns q, q+4, and B rows q, q+4 are W1[c][j0+jl], [+1].
          FragA az;
          split_a(az, dz[0], dz[2], dz[1], dz[3]);
          FragB bx[4];
#pragma unroll
          for (int ct = 0; ct < 4; ++ct) {
            const float2 w = *reinterpret_cast<const float2*>(
                w1s + (ct * 8 + g) * SBT_WS + j0 + jl);
            split_b(bx[ct], w.x, w.y);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int ct = 0; ct < 4; ++ct) mma_term(dxc[ct], az, bx[ct], term);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) dxa[t][i] += dxc[t][i];
      __syncthreads();   // the chunk's dz, h complete

      // Phase B: K = the tile's 128 rows, 8 at a time.
      float t1[2][4] = {}, t2[2][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < SBT_ROWS / 8; ++kk) {
        const int r = kk * 8 + q;
        const float* X = xt + r * SBT_XS + g;
        const float* Z = zs + r * SBT_ZS + warp * 8 + g;
        const float* Hh = hs + r * SBT_ZS + mh + g;
        const float* D = dt + r * SBT_XS + nd + g;
        FragA axt[2], ah;
        FragB bz, bd[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)     // x^T rows c = mt*16 + g (+8)
          split_a(axt[mt], X[mt * 16], X[mt * 16 + 8],
                  X[mt * 16 + 4 * SBT_XS], X[mt * 16 + 8 + 4 * SBT_XS]);
        split_b(bz, Z[0], Z[4 * SBT_ZS]);  // dz column j = warp*8 + g
        db1a[ch] += Z[0] + Z[4 * SBT_ZS];
        split_a(ah, Hh[0], Hh[8], Hh[4 * SBT_ZS], Hh[4 * SBT_ZS + 8]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {   // dd columns c = nd + nt*8 + g
          split_b(bd[nt], D[nt * 8], D[nt * 8 + 4 * SBT_XS]);
          if (ch == 0 && warp < 2)
            db2a[nt] += D[nt * 8] + D[nt * 8 + 4 * SBT_XS];
        }
#pragma unroll
        for (int term = 0; term < 3; ++term) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_term(t1[mt], axt[mt], bz, term);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_term(t2[nt], ah, bd[nt], term);
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc1[ch][t][i] += t1[t][i];
          acc2[ch][t][i] += t2[t][i];
        }
      __syncthreads();   // phase B done with zs, hs (and, last, the tile)
    }

    // dx = W1 dz + gy, summed in float32; dbc sums gy.  WIDE: dx = W1 dz.
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rw + g + (i < 2 ? 0 : 8);
        const int c = t * 8 + 2 * q + (i & 1);
        if (r < nrows && c < c_in) {
          const long idx = (row0 + r) * c_in + c;
          if constexpr (WIDE) {
            dx[idx] = dxa[t][i];
          } else {
            const float gv = gy[idx];
            dbca[t][i & 1] += gv;
            dx[idx] = dxa[t][i] + gv;
          }
        }
      }
  }
  probav::cp_async_wait_all();

  // Write this block's partial slot: every entry of dW1..dbc (WIDE: ..db2).
  const Slot sl(c_in, c_mid, c_dec, !WIDE);
  float* slot = part + blockIdx.x * slot_len;
#pragma unroll
  for (int ch = 0; ch < SBT_NCH; ++ch) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = g + (i < 2 ? 0 : 8), cc = 2 * q + (i & 1);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = t * 16 + rr, j = ch * SBT_CH + warp * 8 + cc;
        if (c < c_in && j < c_mid)
          slot[sl.w1 + (long)c * c_mid + j] = acc1[ch][t][i];
        const int j2 = ch * SBT_CH + mh + rr, c2 = nd + t * 8 + cc;
        if (j2 < c_mid && c2 < c_dec)
          slot[sl.w2 + (long)j2 * c_dec + c2] = acc2[ch][t][i];
      }
    }
    // db1: lanes q hold rows r = q (mod 4) of column j; sum them in order.
    float v = db1a[ch];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int j = ch * SBT_CH + warp * 8 + g;
    if (q == 0 && j < c_mid) slot[sl.b1 + j] = v;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float v = db2a[t];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int c = nd + t * 8 + g;
    if (warp < 2 && q == 0 && c < c_dec) slot[sl.b2 + c] = v;
  }
  if constexpr (!WIDE) {
    // dbc: sum the 8 row groups (lanes g) of each warp, then the warps.
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = dbca[t][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp * 32 + t * 8 + 2 * q + u] = v;
      }
    __syncthreads();
    if (tid < c_in) {
      float sum = 0.f;
      for (int w = 0; w < SBT_WARPS; ++w) sum += red[w * 32 + tid];
      slot[sl.bc + tid] = sum;
    }
  }
}

__global__ void __launch_bounds__(SBT_WARPS * 32, 1)
seg_bwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ dd,
                    const float* __restrict__ gy,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2, float* __restrict__ dx,
                    float* __restrict__ part, long slot_len, int n, int c_in,
                    int c_mid, int c_dec) {
  seg_bwd_tf32_body<false>(x, dd, gy, w1, b1, w2, dx, part, slot_len, n,
                           c_in, c_mid, c_dec);
}

// Shared memory of both: the weights, b1, dz and h, the x and dd (dy)
// tiles, and blk_bwd's dbc sums.
size_t seg_bwd_tf32_smem(bool wide) {
  return sizeof(float) * ((size_t)2 * 32 * SBT_WS + 256 +
                          2 * SBT_ROWS * SBT_ZS + 4 * SBT_ROWS * SBT_XS +
                          (wide ? 0 : SBT_WARPS * 32));
}

cudaError_t launch_seg_bwd_tf32(const void* x, const void* dd, const void* gy,
                                const void* w1, const float* b1,
                                const void* w2, void* dx, float* part,
                                long slot_len, int G, int n, int c_in,
                                int c_mid, int c_dec, cudaStream_t s) {
  const size_t smem = seg_bwd_tf32_smem(false);
  auto kern = seg_bwd_tf32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G, SBT_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dd),
      static_cast<const float*>(gy), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), static_cast<float*>(dx), part, slot_len,
      n, c_in, c_mid, c_dec);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(SBT_WARPS * 32, 1)
wide_bwd_tf32_kernel(const float* __restrict__ x,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ part, long slot_len, int n,
                     int c_in, int c_mid, int c_dec) {
  seg_bwd_tf32_body<true>(x, dy, nullptr, w1, b1, w2, dx, part, slot_len, n,
                          c_in, c_mid, c_dec);
}

cudaError_t launch_wide_bwd_tf32(const void* x, const void* w1,
                                 const float* b1, const void* w2,
                                 const void* dy, void* dx, float* part,
                                 long slot_len, int G, int n, int c_in,
                                 int c_mid, int c_dec, int* used,
                                 cudaStream_t s) {
  const size_t smem = seg_bwd_tf32_smem(true);
  auto kern = wide_bwd_tf32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // One wave: as many blocks as are resident at once (one an SM), each
  // taking every G1-th tile; *used = G1, the slots written (the reduce
  // sums those alone; the rest are neither written nor read).
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      SBT_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const int G1 = std::min(G, std::max(1, per_sm * probav::sm_count()));
  *used = G1;
  kern<<<G1, SBT_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), static_cast<const float*>(dy),
      static_cast<float*>(dx), part, slot_len, n, c_in, c_mid, c_dec);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------ //
// wgrad, float32 on the tensor cores as 3xTF32, for c_dec, c_out <= 32:     //
// wgrad_tf32_kernel.  Per (b, h) row of gy, dWc[tap] += d_shifted^T gy as  //
// mma.sync m16n8k8 with M = 32 channels c, N = 32 outputs o and K = the    //
// row's W*T real positions of gy, rounded up to 8 (gy is zero past them). //
// Up to 64 (the 64-filter model's 51 -> 64, the 48-filter model's         //
// 38 -> 48): wgrad_tf32_tiles_kernel, the same body on 32 x 32 channel     //
// tiles over the grid.                                                    //
// ------------------------------------------------------------------------ //
//
// - Fragments of 32-bit words, no transposition.  A TF32 fragment word is
//   one float, so each is one scalar shared load from the channels-last
//   tiles: A = d^T takes (c = g, g+8; position q, q+4) and B = gy takes
//   (position q, q+4; o = g), g = lane / 4, q = lane % 4.  d's rows are
//   staged as zero-padded (W+2) x (T+2) halo grids of cells of CS = 40
//   floats, each w-row of cells followed by 16 floats of padding: a step
//   of one gy position moves 40 floats within a w-row and 3 * 40 + 16 =
//   136 across one, both 8 (mod 32), so the four positions q of an A load
//   and its eight channels g fall in 32 distinct banks at any T, and a
//   tap's shift (dw, dt) is the constant (dw - 1) (row stride) + (dt - 1)
//   40 from the centre cell prow[k] of gy position k.  gy's row is
//   [position][32] with channel o at o ^ 8 (position % 4), which puts a B
//   load's four positions in four distinct 8-bank groups.
// - Copies straight into the tiles.  Rows of d land by 4-byte cp.async (a
//   position of 25 channels is 100 bytes), rows of gy by 16-byte ones where
//   a position's channels are a multiple of 4 floats (2.5% faster than 4-
//   byte ones at the flagship), else 4-byte ones, on zeros laid once
//   (the halo, channels c_dec..32 and c_out..32, gy past its W*T
//   positions): no raw buffer, no repack.  Rows of d sit in a ring of four
//   slots, global row b*H + h in slot (b*H + h) % 4, and gy in two: while
//   item i (rows i-1 .. i+1) is in the tensor cores, row i+2 of d and row
//   i+1 of gy are in flight.  Rows of the next image follow on the same
//   ring (a warp skips a tap row outside the image), so a block restages
//   only at its first item.
// - Warps: 12, three on each of the SM's four schedulers (9 would put
//   three on one and two on the others).  Warp w owns the h tap dh = w /
//   4, channels 16 (w % 2) .. + 15 and outputs 16 ((w / 2) % 2) .. + 15:
//   nine taps (dw, dt) of one 16 x 16 tile, 72 float32 sums a lane.  A
//   k-step of one dw is 2 prow, 4 B and 12 A loads, their splits and 18
//   mma.
// - Rounding: the tensor cores sum with truncation, so each item's
//   products of one dw go to 24 fresh sums, added in float32 to the 72
//   running sums (in registers across the block's items, written once to
//   its slot, zeros where it had none; the reduce sums the G slots in
//   order); summed straight into the running sums, dWc drifts to 1.2e-5
//   of max|ref| from float64 at the flagship.  96 sums fit three warps'
//   share of a scheduler's registers (168 a thread).  3xTF32 as in
//   seg_bwd_tf32_kernel: lo_a lo_b dropped.
//
// What bounds it on an H100: 2 * 27 * c_dec * c_out FLOP a position, three
// TF32 products each: 72.3 GFLOP at the flagship's N = 557,568 and 25 ->
// 32, 0.146 ms at the 494.7 TFLOP/s TF32 peak (0.360 ms at the CUDA cores'
// 67 TFLOP/s), against 127 MB of d and gy read (0.038 ms): operations.  It
// issues 32 * 32 products a position of the 25 * 32 needed and 200 of 198
// positions a row.  Shared memory at 22 x 9: four d slots of 24 * 456
// floats, two gy slots of 200 * 32 floats and prow: 227,104 B, one block
// per SM.  Larger rows do not fit (W = 23 at T = 9: 236,480 B; W = 48:
// 477,120 B; T = 19 at W = 22: 438,944 B) and take wgrad_kernel
// (wgrad_route, before any launch).  On the card this version takes ~4x
// its bound, and no one unit holds it (tools/wgrad_variants.py): without
// its mma it takes 76% of its time, without the split 79%; the rest is
// the loads of each k-step's chain and their latency, with three warps a
// scheduler to hide them.
//
// The tiles (wgrad_tf32_tiles_kernel, c_dec or c_out beyond 32, up to 64).
// Block s * tiles + t takes channel tile t (32 c's from c0 by 32 o's from
// o0; 2 x 2 at 64/51) of the items of slot s, the items cut into G runs
// as above; a slot's tiles are adjacent, so they run together and read
// each row of d and gy from L2 once it is in, and each writes its tile of
// dWc in its slot: every entry one writer.  A tile is the layout above at
// 32 channels (channels past the tile's zero, as past c_dec there), so its
// shared memory is wgrad_tf32_smem's and it fits where the flagship's does
// (rows up to 22 x 9).  The rows' copies stay with the multiplying warps:
// lane c of warp w copies channel c0 + c of positions w, w + 12, ... by
// 4-byte cp.async (a row of 51 floats is not 16-byte aligned): ~17 copy
// instructions a warp for each row of d and of gy an item (198 positions
// over 12 warps) against its 75 k-steps of 18 mma, so no producer warps
// (they paid at bf16, whose m16n8k16 products take six times fewer mma
// instructions for the same work).  Bound at N = 557,568, 51 -> 64: 98.3
// GFLOP, three
// TF32 products each, 0.596 ms at the TF32 peak (1.467 ms at the CUDA
// cores' 67 TFLOP/s), against 257 MB of d and gy read (0.077 ms):
// operations.  It issues 64 x 64 products a position of the 51 x 64
// needed.

constexpr int WGT_WARPS = 12;
constexpr int WGT_CS = 40;     // floats of a halo cell of d
constexpr int WGT_WPAD = 16;   // floats after each w-row of cells

// Shared-memory bytes of wgrad_tf32_kernel.
size_t wgrad_tf32_smem(int W, int Tn) {
  const size_t npk = ((size_t)W * Tn + 7) / 8 * 8;
  const size_t ws = (size_t)(Tn + 2) * WGT_CS + WGT_WPAD;
  return sizeof(float) * (4 * (size_t)(W + 2) * ws + 2 * npk * 32) +
         sizeof(int) * npk;
}

// The body of wgrad_tf32_kernel (TILES false: one block a slot, every
// channel, c_dec, c_out <= 32) and of wgrad_tf32_tiles_kernel (TILES true,
// c_dec, c_out <= 64: block s * tiles + t takes the 32 x 32 channel tile t,
// from c0 by o0, of slot s's items, and writes that tile of dWc in slot s).
template <bool TILES>
__device__ __forceinline__ void wgrad_tf32_body(
    const float* __restrict__ d, const float* __restrict__ gy,
    float* __restrict__ part, long slot_len, int B, int H, int W, int Tn,
    int c_dec, int c_out) {
  extern __shared__ __align__(16) float smem[];
  const int WT = W * Tn, npk = (WT + 7) / 8 * 8;
  const int WS = (Tn + 2) * WGT_CS + WGT_WPAD;   // a w-row of cells
  const int slot_f = (W + 2) * WS;
  float* slots = smem;                       // [4][W+2][WS]  rows of d
  float* gsl = slots + 4 * slot_f;           // [2][npk][32]  rows of gy
  int* prow = reinterpret_cast<int*>(gsl + 2 * npk * 32);   // [npk]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int dh = warp / 4, mi = warp % 2, np = (warp / 2) % 2;
  // TILES: this block's slot, the slots, and its tile's channels c0 .. c0 +
  // cw - 1 of d and o0 .. o0 + ow - 1 of gy.
  int slot = 0, nslots = 1, c0 = 0, o0 = 0, cw = 0, ow = 0;
  if constexpr (TILES) {
    const int tc = (c_dec + 31) / 32, tiles = tc * ((c_out + 31) / 32);
    const int tile = (int)(blockIdx.x % tiles);
    c0 = 32 * (tile % tc);
    o0 = 32 * (tile / tc);
    cw = min(32, c_dec - c0);
    ow = min(32, c_out - o0);
    slot = (int)(blockIdx.x / tiles);
    nslots = (int)(gridDim.x / tiles);
  }

  // Zeros everywhere the copies never write; the centre cell of each gy
  // position (position 0's past the row, where gy is zero).
  for (int e = tid; e < (4 * slot_f + 2 * npk * 32) / 4; e += nthr)
    reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = tid; k < npk; k += nthr) {
    const int p = k < WT ? k : 0;
    prow[k] = (p / Tn + 1) * WS + (p % Tn + 1) * WGT_CS;
  }
  __syncthreads();   // the zeros stored before any copy lands on them

  const bool gvec = c_out % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(gy) % 16 == 0;
  // Global row r of d into ring slot r % 4, position p at its cell (TILES:
  // the tile's channels, lane c of warp w at positions w, w + 12, ...).
  auto copy_d = [&](long r) {
    float* dst = slots + (int)(r % 4) * slot_f;
    if constexpr (TILES) {
      const float* src = d + r * WT * c_dec + c0;
      if (lane < cw)
        for (int p = warp; p < WT; p += WGT_WARPS)
          probav::cp_async4_zfill(dst + prow[p] + lane, src + p * c_dec + lane,
                                  true);
      return;
    }
    const float* src = d + r * WT * c_dec;
    for (int e = tid; e < WT * c_dec; e += nthr)
      probav::cp_async4_zfill(dst + prow[e / c_dec] + e % c_dec, src + e,
                              true);
  };
  // Row `item` of gy into gy slot buf, channel o of position p at o ^ 8 (p
  // % 4) (TILES: the tile's outputs, 4-byte copies as for d).
  auto copy_g = [&](long item, int buf) {
    float* dst = gsl + buf * npk * 32;
    if constexpr (TILES) {
      const float* src = gy + item * WT * c_out + o0;
      if (lane < ow)
        for (int p = warp; p < WT; p += WGT_WARPS)
          probav::cp_async4_zfill(dst + p * 32 + (lane ^ ((p & 3) << 3)),
                                  src + p * c_out + lane, true);
      return;
    }
    const float* src = gy + item * WT * c_out;
    if (gvec) {
      const int c4 = c_out / 4;
      for (int e = tid; e < WT * c4; e += nthr) {
        const int p = e / c4, o = 4 * (e % c4);
        probav::cp_async16_zfill(dst + p * 32 + (o ^ ((p & 3) << 3)),
                                 src + p * c_out + o, true);
      }
    } else {
      for (int e = tid; e < WT * c_out; e += nthr) {
        const int p = e / c_out, o = e % c_out;
        probav::cp_async4_zfill(dst + p * 32 + (o ^ ((p & 3) << 3)),
                                src + e, true);
      }
    }
  };

  const long items = (long)B * H;
  const long per = TILES ? (items + nslots - 1) / nslots
                         : (items + gridDim.x - 1) / gridDim.x;
  const long i0 = min(items, (long)(TILES ? slot : blockIdx.x) * per);
  const long i1 = min(items, i0 + per);
  if (i0 < i1) {   // the first item's rows i0 - 1 .. i0 + 1 and its gy
    for (long r = max(i0 - 1, 0L); r <= min(i0 + 1, items - 1); ++r)
      copy_d(r);
    copy_g(i0, 0);
    probav::cp_async_commit();
  }

  float acc[3][3][2][4];   // [dw][dt][n-tile][C word]
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[dw][dt][n][0] = acc[dw][dt][n][1] = acc[dw][dt][n][2] =
            acc[dw][dt][n][3] = 0.f;

  // This lane's words: A at channel 16 mi + g (+ 8) of a cell; B (position
  // q of a k-step, output 16 np + 8 n + g) at boff[n] (+ 4 positions).
  const int ach = 16 * mi + g;
  int boff[2];
#pragma unroll
  for (int n = 0; n < 2; ++n)
    boff[n] = q * 32 + ((16 * np + 8 * n + g) ^ (8 * q));
  const int nk = npk / 8;

  for (long item = i0; item < i1; ++item) {
    const int h = (int)(item % H);
    const int buf = (int)((item - i0) & 1);
    probav::cp_async_wait_all();
    __syncthreads();   // this item's rows landed; the last item's products
                       // done with the slots the next copies overwrite
    if (item + 1 < i1) {
      if (item + 2 < items) copy_d(item + 2);
      copy_g(item + 1, buf ^ 1);
      probav::cp_async_commit();
    }
    const int hh = h + dh - 1;
    if (hh < 0 || hh >= H) continue;   // a zero row of d
    // Tap (dw, dt) of position k: cell prow[k] + (dw - 1) WS + (dt - 1) CS.
    const float* arow = slots + (int)((item + dh - 1) % 4) * slot_f + ach -
                        WS - WGT_CS;
    const float* gs = gsl + buf * npk * 32;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      float f[3][2][4];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          f[dt][n][0] = f[dt][n][1] = f[dt][n][2] = f[dt][n][3] = 0.f;
      const float* ap = arow + dw * WS;
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) {
        const float* gk = gs + kk * 8 * 32;
        FragB b[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          split_b(b[n], gk[boff[n]], gk[boff[n] + 4 * 32]);
        const float* a0 = ap + prow[kk * 8 + q];
        const float* a4 = ap + prow[kk * 8 + q + 4];
        FragA a[3];
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
          split_a(a[dt], a0[dt * WGT_CS], a0[dt * WGT_CS + 8],
                  a4[dt * WGT_CS], a4[dt * WGT_CS + 8]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int dt = 0; dt < 3; ++dt)
#pragma unroll
            for (int n = 0; n < 2; ++n) mma_term(f[dt][n], a[dt], b[n], term);
      }
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[dw][dt][n][i] += f[dt][n][i];
    }
  }

  float* out = part + (TILES ? slot : blockIdx.x) * slot_len;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ach + (i < 2 ? 0 : 8);
          const int o = 16 * np + 8 * n + 2 * q + (i & 1);
          const int tap = dh * 9 + dw * 3 + dt;
          if constexpr (TILES) {
            if (c < cw && o < ow)
              out[((long)tap * c_dec + c0 + c) * c_out + o0 + o] =
                  acc[dw][dt][n][i];
          } else if (c < c_dec && o < c_out) {
            out[((long)tap * c_dec + c) * c_out + o] = acc[dw][dt][n][i];
          }
        }
}

__global__ void __launch_bounds__(WGT_WARPS * 32, 1)
wgrad_tf32_kernel(const float* __restrict__ d, const float* __restrict__ gy,
                  float* __restrict__ part, long slot_len, int B, int H,
                  int W, int Tn, int c_dec, int c_out) {
  wgrad_tf32_body<false>(d, gy, part, slot_len, B, H, W, Tn, c_dec, c_out);
}

__global__ void __launch_bounds__(WGT_WARPS * 32, 1)
wgrad_tf32_tiles_kernel(const float* __restrict__ d,
                        const float* __restrict__ gy, float* __restrict__ part,
                        long slot_len, int B, int H, int W, int Tn, int c_dec,
                        int c_out) {
  wgrad_tf32_body<true>(d, gy, part, slot_len, B, H, W, Tn, c_dec, c_out);
}

cudaError_t launch_wgrad_tf32(const void* d, const void* gy, float* part,
                              long slot_len, int G, int B, int H, int W,
                              int Tn, int c_dec, int c_out, cudaStream_t s) {
  const size_t smem = wgrad_tf32_smem(W, Tn);
  auto kern = wgrad_tf32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G, WGT_WARPS * 32, smem, s>>>(
      static_cast<const float*>(d), static_cast<const float*>(gy), part,
      slot_len, B, H, W, Tn, c_dec, c_out);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_tf32_tiles(const void* d, const void* gy,
                                    float* part, long slot_len, int G, int B,
                                    int H, int W, int Tn, int c_dec,
                                    int c_out, cudaStream_t s) {
  const size_t smem = wgrad_tf32_smem(W, Tn);
  auto kern = wgrad_tf32_tiles_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (c_dec + 31) / 32 * ((c_out + 31) / 32);
  kern<<<G * tiles, WGT_WARPS * 32, smem, s>>>(
      static_cast<const float*>(d), static_cast<const float*>(gy), part,
      slot_len, B, H, W, Tn, c_dec, c_out);
  return cudaGetLastError();
}

// Which wgrad blk_bwd runs, from the dtype and shapes alone, on the tensor
// cores where the kernel's layout fits shared memory: bf16 at c_dec, c_out
// <= 32 on wgrad_ring_kernel, up to 64 on wgrad_tiles_kernel (32 x 32
// channel tiles over the grid), float32 at c_dec, c_out <= 32 on
// wgrad_tf32_kernel, up to 64 on wgrad_tf32_tiles_kernel (its 32 x 32
// channel tiles over the grid, the same layout); elsewhere wgrad_kernel on
// the CUDA cores.
enum WgradRoute { WGRAD_CUDA_CORES = 0, WGRAD_BF16_RING = 1,
                  WGRAD_TF32_RING = 2, WGRAD_BF16_TILES = 3,
                  WGRAD_TF32_TILES = 4 };

WgradRoute wgrad_route(int dtype, int c_dec, int c_out, int W, int Tn) {
  const size_t optin = (size_t)probav::optin_smem();
  if (dtype == 1) {
    if (c_dec <= 32 && c_out <= 32)
      return wgrad_ring_smem(W, Tn, c_dec, c_out) <= optin
                 ? WGRAD_BF16_RING : WGRAD_CUDA_CORES;
    return c_dec <= 64 && c_out <= 64 &&
                   wgrad_tiles_smem(W, Tn, c_dec, c_out) <= optin
               ? WGRAD_BF16_TILES : WGRAD_CUDA_CORES;
  }
  if (c_dec > 64 || c_out > 64 || wgrad_tf32_smem(W, Tn) > optin)
    return WGRAD_CUDA_CORES;
  return c_dec <= 32 && c_out <= 32 ? WGRAD_TF32_RING : WGRAD_TF32_TILES;
}

// ------------------------------------------------------------------------ //
// seg_bwd, float32 on the tensor cores as 3xTF32 beyond the flagship's      //
// widths, up to c_in, c_dec <= 64 and c_mid <= 512 (the 0.9411 model's     //
// 64/512/51, the 48-filter model's 48/384/38): seg_bwd_tf32_split_kernel, //
// then dx_sum_kernel<float>.  Together they compute what                 //
// seg_bwd_kernel<float, ..., false> computes, into the same slot layout,   //
// with no rounding point.                                                  //
// ------------------------------------------------------------------------ //
//
// - Why a split.  seg_bwd_tf32_kernel keeps W1 and W2 whole in shared
//   memory and every middle channel j of a row in one block: 225,280 B at
//   32/256, where float32 W1 alone is 131 KB at 64/512.  So, as in
//   seg_bwd_split_kernel, C_mid is cut into chunks over the grid: block b
//   of G x chunks takes chunk b % chunks (STS_JC = 128 j: four at 512,
//   three at 384) of the 64-row tiles of slot b / chunks (a slot's chunks
//   adjacent, so they read x and dd from L2 but once from memory), sums its
//   chunk's dW1, dW2 and db1 over those rows, and writes dx's part from its
//   chunk, dz W1^T over 128 j, as float32 rows of dxp[chunk][n][ldp].
//   dx_sum_kernel adds the chunks' parts in order and gy, and sums gy
//   into dbc.
// - Products taken transposed, as in seg_bwd_split_kernel: warp w of 8
//   owns j = 16 w .. 16 w + 15 of the chunk over every row of a tile; per
//   8 rows z^T = W1^T x^T and W2 dd^T come out of the mma as 16 j x 8 row C
//   tiles over K = 64 channels (eight k-steps), and dz^T = relu'(z) (W2
//   dd), h^T = relu(z) are the A fragments of dW1^T += dz^T x and dW2 +=
//   h^T dd (K = the 8 rows, eight 8-channel n-tiles) in registers: a TF32
//   C tile's columns 2q, 2q + 1 (rows) are fed as A's columns q, q + 4,
//   and the B rows of x and dd are read in that order (the order of k in a
//   dot product is free).  The weights' A fragments of W1^T and W2 are
//   staged once a block in fragment order (a lane's four words adjacent:
//   one 16-byte load a k-step) and split at each load; x^T and dd^T are
//   read as B words from the [row][68] tiles (conflict-free: 68 = 4 mod
//   32) and split.  A pass takes 32 rows: z^T and W2 dd^T of four n-tiles
//   (32 registers) live while their products and the weight gradients run.
// - Phase C, dx's part: dz^T goes to shared memory ([j][row], stride 72,
//   float2 stores of C word pairs, conflict-free); after a barrier warp w
//   computes rows 16 (w % 4) .. + 15 by channels 32 (w / 4) .. + 31 over
//   the chunk's 128 j (A = dz from dz^T, B = W1^T from a third plane staged
//   once in B-fragment order, a lane's two words adjacent) and stores them
//   as float2.
// - Rounding: none (float32 blk_bwd has no rounding point); the tensor
//   cores sum with truncation, so each tile's weight-gradient products go
//   to fresh sums, added in float32 to the running sums (registers across
//   the block's tiles, written once to its slot); z and W2 dd are complete
//   sums of one tile, and dx's part is summed over one chunk.  No atomics:
//   every entry of a slot has one writer (dWc the wgrad's, dbc
//   dx_sum_kernel's).
// - Staging: 64-row tiles of x and dd, double-buffered by cp.async
//   (copy_rows: 16-byte copies where a row is a multiple of 4 floats, else
//   4-byte ones: dd's 51 channels), zeros past n; the tiles' columns from
//   c_in and c_dec on are zeroed once.  Two barriers a tile: the tile staged
//   (and the last phase C done with dz^T), and before phase C.
// - Sums: db1 from dz^T's C words a lane, db2 from dd's B words (warp w
//   those of row group w), reduced over lanes and warps in a fixed order;
//   the chunk-0 block writes db2.  Rows past n are zero in x and dd, so
//   they add nothing (h there is relu(b1), against dd = 0); their dx parts
//   are not stored.
//
// What bounds it on an H100 at the 64-filter model's train step (N =
// 557,568, 64/512/51): 2 N c_mid (3 c_in + 2 c_dec) = 167.9 GFLOP, three
// TF32 products each, 1.018 ms at the 494.7 TFLOP/s TF32 peak (2.506 ms at
// the CUDA cores' 67 TFLOP/s), against 542 MB of x, dd, gy read and dx
// written (0.162 ms): operations.  It issues products at c_dec padded to
// 64.  The split adds dx's float32 parts, written and read once each: 2 x
// 4 x N x 64 x 4 = 1.14 GB (0.341 ms at 3.35 TB/s).  One block of 8 warps
// an SM: 207,360 bytes of shared memory (three weight planes of 128 x 64
// floats, b1, two each of the x and dd tiles [64][68], dz^T [128][72], the
// db2 sums).

constexpr int STS_WARPS = 8;     // each owns STS_JC / STS_WARPS = 16 j
constexpr int STS_ROWS = 64;     // rows per tile
constexpr int STS_PASS = 4;      // 8-row n-tiles a pass of the products
constexpr int STS_JC = 128;      // middle channels a block: its chunk
constexpr int STS_CH = 64;       // c_in, c_dec it takes (zero-padded)
constexpr int STS_XS = STS_CH + 4;     // x / dd tile row stride (floats)
constexpr int STS_ZS = STS_ROWS + 8;   // dz^T [j][row] row stride
constexpr int STS_PLANE = STS_JC * STS_CH;   // floats of a weight plane

int seg_bwd_tf32_split_chunks(int c_mid) {
  return (c_mid + STS_JC - 1) / STS_JC;
}

size_t seg_bwd_tf32_split_smem() {
  return sizeof(float) * ((size_t)3 * STS_PLANE + STS_JC +
                          4 * STS_ROWS * STS_XS + STS_JC * STS_ZS +
                          STS_WARPS * STS_CH);
}

__global__ void __launch_bounds__(STS_WARPS * 32, 1)
seg_bwd_tf32_split_kernel(const float* __restrict__ x,
                          const float* __restrict__ dd,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          float* __restrict__ dxp, int ldp,
                          float* __restrict__ part, long slot_len,
                          int chunks, int n, int c_in, int c_mid,
                          int c_dec) {
  constexpr int ROWS = STS_ROWS, XS = STS_XS, ZS = STS_ZS, JC = STS_JC;
  constexpr int KS = STS_CH / 8;               // k-steps over the channels
  static_assert(JC == 16 * STS_WARPS, "16 j a warp");
  static_assert(ROWS == 8 * STS_WARPS, "db2: a row group a warp");
  static_assert(ROWS % (8 * STS_PASS) == 0, "whole passes a tile");
  extern __shared__ __align__(16) float smem[];
  float* wa1 = smem;                   // [W][KS][32][4]  W1^T A words
  float* wa2 = wa1 + STS_PLANE;        // [W][KS][32][4]  W2 A words
  float* wb1 = wa2 + STS_PLANE;        // [JC/8][8][32][2]  W1^T B words
  float* b1s = wb1 + STS_PLANE;        // [JC]
  float* xb = b1s + JC;                // [2][ROWS][XS]  x tiles
  float* db = xb + 2 * ROWS * XS;      // [2][ROWS][XS]  dd tiles
  float* zt = db + 2 * ROWS * XS;      // [JC][ZS]  dz^T of a tile
  float* red = zt + JC * ZS;           // [W][64]  db2 sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int chunk = (int)(blockIdx.x % chunks);
  const int slot_i = (int)(blockIdx.x / chunks);
  const int G = (int)(gridDim.x / chunks);   // slots: row-tile strides
  const int j0 = chunk * JC;                 // the chunk's first j
  const int J0 = 16 * warp;                  // this warp's j in the chunk

  // The chunk's weights, zero-padded to JC x 64 (padded z, dz and h are
  // 0), in fragment order: wa1/wa2 word i of lane (g, q), warp w, k-step
  // k is W1[c][j] / W2[j][c] at j = J0 + g + 8 (i & 1), c = 8 k + q + 4 (i
  // >> 1); wb1 word u of lane (g, q), j-step s, c-tile t is W1[c][j] at c =
  // 8 t + g, j = 8 s + q + 4 u.
  auto w1_at = [&](int c, int j) {
    return c < c_in && j0 + j < c_mid ? w1[(long)c * c_mid + j0 + j] : 0.f;
  };
  for (int e = tid; e < STS_PLANE; e += blockDim.x) {
    const int i = e % 4, l = (e / 4) % 32, k = (e / 128) % KS, w = e / 128 / KS;
    const int j = 16 * w + l / 4 + 8 * (i & 1), c = 8 * k + l % 4 + 4 * (i >> 1);
    wa1[e] = w1_at(c, j);
    wa2[e] = j0 + j < c_mid && c < c_dec ? w2[(long)(j0 + j) * c_dec + c]
                                         : 0.f;
    const int u = e % 2, lb = (e / 2) % 32, t = (e / 64) % 8, s = e / 512;
    wb1[e] = w1_at(8 * t + lb / 4, 8 * s + lb % 4 + 4 * u);
  }
  for (int j = tid; j < JC; j += blockDim.x)
    b1s[j] = j0 + j < c_mid ? b1[j0 + j] : 0.f;
  for (int e = tid; e < 4 * ROWS * XS; e += blockDim.x) xb[e] = 0.f;
  __syncthreads();   // the zeros land before any copy into the tiles

  const bool xvec = c_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool dvec = c_dec % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(dd) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  auto stage = [&](long tile, int buf) {
    const long row0 = tile * ROWS;
    const int nrows = (int)min((long)ROWS, (long)n - row0);
    copy_rows<ROWS, XS>(xb + buf * ROWS * XS, x + row0 * c_in, nrows, c_in,
                        xvec);
    copy_rows<ROWS, XS>(db + buf * ROWS * XS, dd + row0 * c_dec, nrows, c_dec,
                        dvec);
    probav::cp_async_commit();
  };

  const float bias0 = b1s[J0 + g], bias1 = b1s[J0 + g + 8];
  float acc1[8][4], acc2[8][4];   // dW1^T (j, c), dW2 (j, c) running sums
#pragma unroll
  for (int ct = 0; ct < 8; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[ct][i] = acc2[ct][i] = 0.f;
  float db1a[2] = {}, db2a[8] = {};

  const float4* wa1v = reinterpret_cast<const float4*>(wa1) + warp * KS * 32 +
                       lane;
  const float4* wa2v = reinterpret_cast<const float4*>(wa2) + warp * KS * 32 +
                       lane;
  const int pr0 = 16 * (warp % 4);      // phase C: this warp's rows
  const int ct0 = 4 * (warp / 4);       // and 8-column tiles of dx
  const float2* wbv = reinterpret_cast<const float2*>(wb1) + ct0 * 32 + lane;
  float* dxc_dst = dxp + (long)chunk * n * ldp;
  if (slot_i < tiles) stage(slot_i, 0);
  int buf = 0;
  for (long tile = slot_i; tile < tiles; tile += G, buf ^= 1) {
    // The other buffer was last read before the previous tile's second
    // barrier.
    if (tile + G < tiles) stage(tile + G, buf ^ 1);
    else probav::cp_async_commit();
    probav::cp_async_wait_group<1>();
    __syncthreads();   // this tile staged; the last phase C done with dz^T
    const float* xt = xb + buf * ROWS * XS;
    const float* dt = db + buf * ROWS * XS;
    float f1[8][4], f2[8][4];   // this tile's dW1^T, dW2 products
#pragma unroll
    for (int ct = 0; ct < 8; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) f1[ct][i] = f2[ct][i] = 0.f;

#pragma unroll 1
    for (int r0 = 0; r0 < ROWS; r0 += 8 * STS_PASS) {
      // z^T and W2 dd^T of rows r0 .. r0 + 8 PASS - 1: C tile nt holds j =
      // J0 + g (+ 8) by rows r0 + 8 nt + 2q (+ 1).
      float z[STS_PASS][4], gg[STS_PASS][4];
#pragma unroll
      for (int nt = 0; nt < STS_PASS; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) z[nt][i] = gg[nt][i] = 0.f;
#pragma unroll 2
      for (int k = 0; k < KS; ++k) {
        FragA a1, a2;
        const float4 u = wa1v[k * 32], v = wa2v[k * 32];
        split_a(a1, u.x, u.y, u.z, u.w);
        split_a(a2, v.x, v.y, v.z, v.w);
        FragB bx[STS_PASS], bd[STS_PASS];
#pragma unroll
        for (int nt = 0; nt < STS_PASS; ++nt) {   // x^T, dd^T: (c q, row g)
          const int o = (r0 + 8 * nt + g) * XS + 8 * k + q;
          split_b(bx[nt], xt[o], xt[o + 4]);
          split_b(bd[nt], dt[o], dt[o + 4]);
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int nt = 0; nt < STS_PASS; ++nt) {
            mma_term(z[nt], a1, bx[nt], term);
            mma_term(gg[nt], a2, bd[nt], term);
          }
      }
#pragma unroll
      for (int nt = 0; nt < STS_PASS; ++nt) {
        const int rb = r0 + 8 * nt;     // the n-tile's first row
        float dz[4], h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float zz = z[nt][i] + (i < 2 ? bias0 : bias1);
          dz[i] = zz > 0.f ? gg[nt][i] : 0.f;
          h[i] = fmaxf(zz, 0.f);
        }
        db1a[0] += dz[0] + dz[1];
        db1a[1] += dz[2] + dz[3];
        *reinterpret_cast<float2*>(zt + (J0 + g) * ZS + rb + 2 * q) =
            make_float2(dz[0], dz[1]);
        *reinterpret_cast<float2*>(zt + (J0 + g + 8) * ZS + rb + 2 * q) =
            make_float2(dz[2], dz[3]);
        // C words (j g, rows 2q, 2q + 1; j g + 8, ...) as A words (j, k q)
        // and (j, k q + 4): k q is row 2q, k q + 4 row 2q + 1.
        FragA az, ah;
        split_a(az, dz[0], dz[2], dz[1], dz[3]);
        split_a(ah, h[0], h[2], h[1], h[3]);
        const float on = rb == 8 * warp ? 1.f : 0.f;   // db2: row group w
#pragma unroll
        for (int cp = 0; cp < 4; ++cp) {
          FragB bx[2], bd[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {   // x, dd: (row 2q, 2q + 1; c g)
            const int o = (rb + 2 * q) * XS + 8 * (2 * cp + u) + g;
            split_b(bx[u], xt[o], xt[o + XS]);
            split_b(bd[u], dt[o], dt[o + XS]);
            db2a[2 * cp + u] = fmaf(on, dt[o] + dt[o + XS],
                                    db2a[2 * cp + u]);
          }
#pragma unroll
          for (int term = 0; term < 3; ++term)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              mma_term(f1[2 * cp + u], az, bx[u], term);
              mma_term(f2[2 * cp + u], ah, bd[u], term);
            }
        }
      }
    }
#pragma unroll
    for (int ct = 0; ct < 8; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc1[ct][i] += f1[ct][i];
        acc2[ct][i] += f2[ct][i];
      }
    __syncthreads();   // dz^T of the tile complete

    // Phase C: dx's part from this chunk for rows pr0 .. pr0 + 15 and this
    // warp's four c-tiles, over the chunk's 128 j, 8 a k-step.
    float dxc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 2
    for (int s = 0; s < JC / 8; ++s) {
      const float* Z = zt + (8 * s + q) * ZS + pr0 + g;   // (row g, j q)
      FragA a;
      split_a(a, Z[0], Z[8], Z[4 * ZS], Z[4 * ZS + 8]);
      FragB b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 w = wbv[(8 * s + t) * 32];
        split_b(b[t], w.x, w.y);
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_term(dxc[t], a, b[t], term);
    }
    const long row0 = tile * ROWS;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long row = row0 + pr0 + g + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = 8 * (ct0 + t) + 2 * q;
        if (c < ldp)
          *reinterpret_cast<float2*>(dxc_dst + row * ldp + c) =
              make_float2(dxc[t][2 * hh], dxc[t][2 * hh + 1]);
      }
    }
  }
  probav::cp_async_wait_all();

  // This block's part of its slot: dW1 [c][j0..], dW2 [j0..][c], db1
  // [j0..], and from the chunk-0 block db2.
  const Slot sl(c_in, c_mid, c_dec);
  float* slot = part + slot_i * slot_len;
#pragma unroll
  for (int ct = 0; ct < 8; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + J0 + g + 8 * (i / 2);
      const int c = 8 * ct + 2 * q + (i & 1);
      if (j >= c_mid) continue;
      if (c < c_in) slot[sl.w1 + (long)c * c_mid + j] = acc1[ct][i];
      if (c < c_dec) slot[sl.w2 + (long)j * c_dec + c] = acc2[ct][i];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    // db1: lanes q hold rows 2q, 2q + 1 (mod 8) of j; summed in order.
    float v = db1a[hh];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int j = j0 + J0 + g + 8 * hh;
    if (q == 0 && j < c_mid) slot[sl.b1 + j] = v;
  }
  if (chunk == 0) {
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {   // db2 of this warp's row group
      float v = db2a[ct];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) red[warp * STS_CH + 8 * ct + g] = v;
    }
    __syncthreads();
    if (tid < c_dec) {
      float sum = 0.f;
      for (int w = 0; w < STS_WARPS; ++w) sum += red[w * STS_CH + tid];
      slot[sl.b2 + tid] = sum;
    }
  }
}

cudaError_t launch_seg_bwd_tf32_split(const void* x, const void* dd,
                                      const void* gy, const void* w1,
                                      const float* b1, const void* w2,
                                      void* dx, float* dxp, float* part,
                                      long slot_len, int G, int n, int c_in,
                                      int c_mid, int c_dec, cudaStream_t s) {
  if (dxp == nullptr) return cudaErrorInvalidValue;
  const int chunks = seg_bwd_tf32_split_chunks(c_mid);
  const int ldp = seg_bwd_split_ldp(c_in);
  const size_t smem = seg_bwd_tf32_split_smem();
  auto kern = seg_bwd_tf32_split_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<G * chunks, STS_WARPS * 32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dd),
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2), dxp,
      ldp, part, slot_len, chunks, n, c_in, c_mid, c_dec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dx_sum(dxp, chunks, ldp, static_cast<const float*>(gy),
                       static_cast<float*>(dx), part, slot_len, G, n, c_in,
                       Slot(c_in, c_mid, c_dec).bc, s);
}

// Which seg_bwd blk_bwd runs, from the dtype and widths alone: the tensor
// cores where their tiles cover the widths: at c_in, c_dec <= 32 and c_mid
// <= 256 bf16 on seg_bwd_bf16_kernel and float32 on seg_bwd_tf32_kernel;
// beyond, up to c_in, c_dec <= 64 and c_mid <= 512, bf16 on
// seg_bwd_split_kernel and dx_sum_kernel and float32 on
// seg_bwd_tf32_split_kernel and dx_sum_kernel; elsewhere seg_bwd_kernel
// on the CUDA cores.
enum SegBwdRoute { SEG_BWD_CUDA_CORES = 0, SEG_BWD_BF16_MMA = 1,
                   SEG_BWD_TF32_MMA = 2, SEG_BWD_BF16_SPLIT = 3,
                   SEG_BWD_TF32_SPLIT = 4 };

SegBwdRoute seg_bwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  if (c_in <= 32 && c_dec <= 32 && c_mid <= 256)
    return dtype == 1 ? SEG_BWD_BF16_MMA : SEG_BWD_TF32_MMA;
  if (c_in <= SBS_CH && c_dec <= SBS_CH && c_mid <= 2 * SBS_JC)
    return dtype == 1 ? SEG_BWD_BF16_SPLIT : SEG_BWD_TF32_SPLIT;
  return SEG_BWD_CUDA_CORES;
}

// Floats of dx's float32 parts blk_bwd needs at n rows (the caller's
// scratch dxp), 0 where its seg_bwd route keeps none.
long seg_bwd_scratch(int dtype, int c_in, int c_mid, int c_dec, long n) {
  switch (seg_bwd_route(dtype, c_in, c_mid, c_dec)) {
    case SEG_BWD_BF16_SPLIT:
      return (long)seg_bwd_split_chunks(c_mid) * n * seg_bwd_split_ldp(c_in);
    case SEG_BWD_TF32_SPLIT:
      return (long)seg_bwd_tf32_split_chunks(c_mid) * n *
             seg_bwd_split_ldp(c_in);
    default:
      return 0;
  }
}

// ------------------------------------------------------------------------ //
// wide_bwd, bf16 on the tensor cores (mma.sync.m16n8k16, float32 sums), for //
// c_in, c_dec <= 32 and c_mid <= 256 (the flagship's 32/256/25):           //
// wide_bwd_bf16_kernel.  It computes what seg_bwd_kernel<__nv_bfloat16,    //
// ..., true> computes (ops/wide_block.wide_bwd_plain), into the same slot  //
// layout (no dWc, no dbc), with dz and relu(z) kept in float32.            //
// ------------------------------------------------------------------------ //
//
// Replaces, at bf16, the TPU kernel _bwd of
// probav_tpu/ops/pallas_wide_block.py:110 (body _bwd_kernel :78).
// - The products of seg_bwd_bf16_kernel, taken transposed: warp w of 8 owns
//   the middle channels j of 32 w .. 32 w + 31 over every row of a tile, 16
//   rows at a time; z^T = W1^T x^T + b1 and W2 dy^T come out of the mma as
//   16 j x 8 row C tiles (W1^T and W2's A fragments stay in registers for
//   the block's life), and two C tiles adjacent in rows are the A fragment
//   of dW1^T += dz^T x and dW2 += h^T dy, whose B fragments are x and dy by
//   ldmatrix.trans.  dW1^T and dW2 sum in the warp's registers over all of
//   the block's tiles and are written once.
// - Float32 operands on bf16 units: dz^T = relu'(z) (W2 dy^T) and h^T =
//   relu(z) stay float32 in the C registers.  Each pair splits into three
//   bf16x2 words, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
//   (split3_bf16x2): both differences are exact in float32 and hi + mid +
//   lo = v for every float32 v whose pieces stay normal, and a piece times
//   a bf16 value is exact in float32, so three mma (lo, mid, then hi, into
//   the same sums) give each product to float32 accuracy.  No value is
//   rounded to bf16 once: that is seg_bwd_bf16_kernel's dz and h.
// - dx = dz W1^T needs every j of a row: dz goes to shared memory as float32
//   [row][j] (row stride 260, 4 mod 32: the C-fragment stores and the
//   ldmatrix rows below are conflict-free), one buffer of a 128-row tile,
//   and phase C, after the tile's products (a barrier on each side),
//   computes dx for 16 rows and all 32 columns a warp, so each dz value is
//   loaded and split once.  (Two buffers of 64-row tiles, with phase C
//   beside the next tile's products, split each dz twice, for two warps'
//   16 columns: 13% slower, tools/seg_bwd_variants.py --section wide; two
//   128-row buffers do not fit.)  Its A fragments come by plain ldmatrix of the
//   float32 rows: ldmatrix hands lane (g, q) word q of row g of each 8x8
//   b16 matrix, here dz[g][j0 + 4 i + q] of matrix i, so the fragment's k
//   order is permuted (k = 2q, 2q + 1, 2q + 8, 2q + 9 hold j0 + q, + 4 + q,
//   + 8 + q, + 12 + q) and W1^T's B fragments (ldmatrix.trans of the one
//   [j][c] copy of W1) take their rows in the same order.  Each pair is
//   split three ways there too; dx sums in float32 and is rounded to bf16
//   once, staged per warp and stored as 16-byte row pieces.
// - Staging: x by 16-byte cp.async into [row][40] double buffers (plain
//   copies where c_in % 8 != 0 or x or dx is off the 16-byte grid), zeros
//   past n; warp w copies the dy of rows 16 w .. 16 w + 15 of the next tile,
//   one contiguous span, into its own raw buffer and repacks it to [row][40],
//   zeros past c_dec and past n.  x's pad columns c_in .. 31 are zeroed once
//   and nothing writes there: the fragments read them against W1's zero
//   rows, and 0 x NaN is NaN.
// - db1 sums dz^T's float32 C fragments per lane, db2 dy's .trans B
//   fragments (warp w those of row group w); both are reduced over the
//   lanes and warps in a fixed order.  Rows past n add nothing (dy = 0
//   there, so dz = 0, against h = relu(b1)).
//
// What bounds it on an H100 at the flagship (N = 557,568): z and W2 dy are
// 16.3 GFLOP of bf16 products; dx, dW1 and dW2 are 25.4 GFLOP with one
// float32 operand, three bf16 products each here: 92.5 GFLOP at the 989
// TFLOP/s bf16 peak, 0.094 ms, against 99 MB of x, dy and dx (0.030 ms):
// operations.  What holds it is mma.sync (11 products a row where
// seg_bwd_bf16_kernel has 5): without them it takes a quarter of its time
// (tools/seg_bwd_variants.py --section wide), and the splits' ALU work
// shares the two warps a scheduler's issue slots.  One block of 8 warps an
// SM: 214,272 bytes of shared memory (the dz buffer [128][260] float32,
// holding W2 while the fragments load; W1 [256][40]; two each of the x and
// dy tiles; the dx tile; the warps' raw dy spans; the db2 sums).  So the
// launch is one wave of as many blocks as are resident, the rest of the
// wrapper's G slots zeroed: G blocks in two waves, each staging W1, W2 and
// the fragments again, were 3% slower.

constexpr int WBB_WARPS = 8;       // each owns 256 / WBB_WARPS middle channels
constexpr int WBB_ROWS = 128;      // rows per tile: phase C's 16 a warp
constexpr int WBB_CS = 40;         // bf16 row stride: x, dy, dx tiles; W1, W2
constexpr int WBB_ZS = 256 + 4;    // float32 dz [row][j] row stride
constexpr int WBB_RPW = WBB_ROWS / WBB_WARPS;            // dy rows a warp
constexpr int WBB_RAWW = (WBB_RPW * 64 + 43) / 16 * 8;   // its raw dy span

size_t wide_bwd_bf16_smem() {
  return sizeof(float) * ((size_t)WBB_ROWS * WBB_ZS + WBB_WARPS * 32) +
         sizeof(__nv_bfloat16) * ((size_t)256 * WBB_CS +
                                  5 * WBB_ROWS * WBB_CS +
                                  WBB_WARPS * WBB_RAWW);
}

// hi, mid and lo of the float32 pair (v0, v1) as bf16x2 words, v0 in the
// low half: v = hi + mid + lo, each difference taken exactly.
__device__ __forceinline__ void split3_bf16x2(float v0, float v1,
                                              uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  using probav::pack_bf16;
  hi = pack_bf16(v0, v1);
  const float r0 = v0 - __uint_as_float(hi << 16);
  const float r1 = v1 - __uint_as_float(hi & 0xffff0000u);
  mid = pack_bf16(r0, r1);
  lo = pack_bf16(r0 - __uint_as_float(mid << 16),
                 r1 - __uint_as_float(mid & 0xffff0000u));
}

__global__ void __launch_bounds__(WBB_WARPS * 32, 1)
wide_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const __nv_bfloat16* __restrict__ dy,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                     long slot_len, int n, int c_in, int c_mid, int c_dec) {
  using E = __nv_bfloat16;
  using probav::ldsm_x4;
  using probav::ldsm_x4_trans;
  using probav::mma_bf16;
  using probav::pack2;
  using probav::pack_bf16;
  constexpr int ROWS = WBB_ROWS, CS = WBB_CS, ZS = WBB_ZS, RPW = WBB_RPW;
  constexpr int MT = 256 / (16 * WBB_WARPS);   // 16-j m-tiles a warp
  constexpr int RG = ROWS / 16;                // 16-row groups a tile
  static_assert(MT >= 1 && MT * 16 * WBB_WARPS == 256, "j per warp");
  static_assert(RG == WBB_WARPS, "phase C: a row group a warp");
  static_assert(ROWS * ZS >= 256 * 32, "W2 and dW1 staged in the dz space");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zb = reinterpret_cast<float*>(smem_raw);   // [ROWS][ZS] dz
  E* w2s = reinterpret_cast<E*>(zb);                // [256][CS] w2, loading
  E* w1s = reinterpret_cast<E*>(zb + ROWS * ZS);    // [256][CS]
  E* xb = w1s + 256 * CS;                    // [2][ROWS][CS]  x tiles
  E* dyt = xb + 2 * ROWS * CS;               // [2][ROWS][CS]  dy tiles
  E* dxs = dyt + 2 * ROWS * CS;              // [ROWS][CS]  dx staging
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  E* raw = dxs + ROWS * CS + warp * WBB_RAWW;   // this warp's dy span
  float* red = reinterpret_cast<float*>(dxs + ROWS * CS +
                                        WBB_WARPS * WBB_RAWW);   // [W][32]
  const E zero = __float2bfloat16_rn(0.f);
  const int g = lane / 4, q = lane % 4;
  const int J0 = warp * 16 * MT;             // this warp's middle channels
  const int dr0 = RPW * warp;                // and the dy rows it stages

  // W1, W2 as [j][c], zero-padded to 256 x 32 (padded z, dz, h are 0); the
  // x tiles zeroed once (the copies never write their columns from c_in
  // on).
  for (int e = tid; e < 256 * 32; e += blockDim.x) {
    const int c = e / 256, j = e % 256;
    w1s[j * CS + c] = (c < c_in && j < c_mid) ? w1[(long)c * c_mid + j] : zero;
    const int j2 = e / 32, c2 = e % 32;
    w2s[j2 * CS + c2] =
        (j2 < c_mid && c2 < c_dec) ? w2[(long)j2 * c_dec + c2] : zero;
  }
  for (int e = tid; e < 2 * ROWS * CS / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(xb)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // This warp's A fragments of W1^T and W2 (M = its j, K = c) and its b1.
  uint32_t wa[MT][2][4], wb[MT][2][4];
  float bias[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = J0 + 16 * mt + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldsm_x4(wa[mt][ks], w1s + row * CS + 16 * ks + 8 * (lane / 16));
      ldsm_x4(wb[mt][ks], w2s + row * CS + 16 * ks + 8 * (lane / 16));
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = J0 + 16 * mt + g + 8 * hh;
      bias[mt][hh] = j < c_mid ? b1[j] : 0.f;
    }
  }
  __syncthreads();   // w2s read: zb may be written

  float acc1[MT][4][4], acc2[MT][4][4];   // dW1^T (j, c), dW2 (j, c) tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc1[mt][ct][i] = acc2[mt][ct][i] = 0.f;
  float db1a[MT][2] = {}, db2a[4] = {};

  const bool vec = c_in % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const long tiles = ((long)n + ROWS - 1) / ROWS;
  auto rows_of = [&](long t) {
    return (int)min((long)ROWS, (long)n - t * ROWS);
  };
  // Rows [0, nr) of x from tile t into dst (zeros past nr), block-wide:
  // 16-byte cp.async where `vec`, else plain copies.
  auto stage_x = [&](E* dst, long t, int nr) {
    const E* src = x + t * ROWS * c_in;
    if (vec) {
      const int c8 = c_in / 8;
      for (int e = tid; e < ROWS * c8; e += blockDim.x) {
        const int r = e / c8, c = 8 * (e % c8);
        const bool in = r < nr;
        probav::cp_async16_zfill(dst + r * CS + c,
                                 in ? src + r * c_in + c : src, in);
      }
    } else {
      for (int e = tid; e < ROWS * c_in; e += blockDim.x) {
        const int r = e / c_in, c = e % c_in;
        dst[r * CS + c] = r < nr ? src[r * c_in + c] : zero;
      }
    }
  };
  // This warp's RPW rows of dy from tile t: the span of its real rows, by
  // 16-byte cp.async from the chunk below its start; returns the element
  // offset of the span in raw.
  auto copy_dy = [&](long t) {
    const int nrw = min(RPW, rows_of(t) - dr0);
    if (nrw <= 0) return 0;
    const uintptr_t s = reinterpret_cast<uintptr_t>(
        dy + (t * ROWS + dr0) * c_dec);
    const uintptr_t a = s & ~uintptr_t(15);
    const int chunks = (int)((s + 2 * (uintptr_t)(nrw * c_dec) + 15 - a) / 16);
    for (int i = lane; i < chunks; i += 32)
      probav::cp_async16(raw + 8 * i, a + 16 * (uintptr_t)i);
    return (int)((s - a) / 2);
  };
  // ... and its repack into rows dr0 .. dr0 + RPW - 1 of a dy tile: 8
  // channels a step, zeros from c_dec and past the tile's nr rows.
  auto repack = [&](E* dst, int skew, int nr) {
    const E* src = raw + skew;
    for (int u = lane; u < RPW * 4; u += 32) {
      const int p = u / 4, j = u % 4;
      const E* s = src + p * c_dec + 8 * j;
      const bool in = dr0 + p < nr;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 8 * j + 2 * k;
        v[k] = pack2(in && c < c_dec ? s[2 * k] : zero,
                     in && c + 1 < c_dec ? s[2 * k + 1] : zero);
      }
      *reinterpret_cast<uint4*>(dst + (dr0 + p) * CS + 8 * j) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  };

  const int pr0 = 16 * warp;                 // this warp's phase-C rows
  float dxc[4][4];                           // and its dx tiles (8 columns)
  // Phase C, k-steps 2 kp and 2 kp + 1 (16 j each) of dx = dz W1^T for rows
  // pr0 .. pr0 + 15 and all 32 columns: A by plain ldmatrix of the dz
  // buffer's float32 words (rows pr0 + l % 8, and + 8, words j0 + 4 (l /
  // 8) ..), split three ways; B = W1^T by ldmatrix.trans, rows in the A
  // fragment's k order.
  const int zoff = (pr0 + lane % 8) * ZS + 4 * (lane / 8);
  const E* wp = w1s + (8 * ((lane / 8) % 2) + 4 * (lane % 2) +
                       (lane % 8) / 2) * CS + 8 * (lane / 16);
  auto phase_c = [&](int kp) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * kp + kk;
      uint32_t r[4], s[4], a[3][4], b[2][4];
      ldsm_x4(r, zb + zoff + 16 * ks);
      ldsm_x4(s, zb + zoff + 8 * ZS + 16 * ks);
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // rows g (i = 0, 2), g + 8 (1, 3)
        split3_bf16x2(__uint_as_float(r[2 * i]), __uint_as_float(r[2 * i + 1]),
                      a[0][2 * i], a[1][2 * i], a[2][2 * i]);
        split3_bf16x2(__uint_as_float(s[2 * i]), __uint_as_float(s[2 * i + 1]),
                      a[0][2 * i + 1], a[1][2 * i + 1], a[2][2 * i + 1]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldsm_x4_trans(b[p], wp + ks * 16 * CS + 16 * p);
#pragma unroll
      for (int pc = 2; pc >= 0; --pc)   // lo, mid, hi
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_bf16(dxc[2 * p], a[pc], b[p][0], b[p][1]);
          mma_bf16(dxc[2 * p + 1], a[pc], b[p][2], b[p][3]);
        }
    }
  };
  // The epilogue of tile t: dx in bf16, staged in this warp's rows of the
  // dx tile, stored as 16-byte pieces of rows.
  auto epilogue = [&](long t) {
    const int nrw = min(16, rows_of(t) - pr0);
    __syncwarp();   // the previous epilogue's loads of the dx tile done
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dxs + (pr0 + g + 8 * hh) * CS + 8 * c +
                                     2 * q) =
            pack_bf16(dxc[c][2 * hh], dxc[c][2 * hh + 1]);
    __syncwarp();
    E* dst = dx + (t * ROWS + pr0) * c_in;
    if (vec) {
      for (int e = lane; e < 16 * 4; e += 32) {
        const int r = e / 4, c = 8 * (e % 4);
        if (r < nrw && c < c_in)
          *reinterpret_cast<uint4*>(dst + r * c_in + c) =
              *reinterpret_cast<const uint4*>(dxs + (pr0 + r) * CS + c);
      }
    } else {
      for (int e = lane; e < 16 * 32; e += 32) {
        const int r = e / 32, c = e % 32;
        if (r < nrw && c < c_in) dst[r * c_in + c] = dxs[(pr0 + r) * CS + c];
      }
    }
  };

  if (blockIdx.x < tiles) {
    stage_x(xb, blockIdx.x, rows_of(blockIdx.x));
    const int skew = copy_dy(blockIdx.x);
    probav::cp_async_commit();
    probav::cp_async_wait_all();
    __syncwarp();
    repack(dyt, skew, rows_of(blockIdx.x));
  }
  // Tile k of this block in the x and dy buffers k % 2: its products, then
  // its phase C and epilogue.
  int buf = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    // x, dy of this tile staged; the previous tile's phase C done.
    __syncthreads();
    const long next = tile + gridDim.x;
    int skew = 0;
    if (next < tiles) {
      stage_x(xb + (buf ^ 1) * ROWS * CS, next, rows_of(next));
      skew = copy_dy(next);
    }
    probav::cp_async_commit();            // group: the next tile's x, dy

    const E* xt = xb + buf * ROWS * CS;
    const E* dt = dyt + buf * ROWS * CS;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      dxc[t][0] = dxc[t][1] = dxc[t][2] = dxc[t][3] = 0.f;
#pragma unroll 1
    for (int rg = 0; rg < RG; ++rg) {
      const int r0 = 16 * rg;
      // Phases A and B: this warp's j over rows r0 .. r0 + 15.  B of z^T
      // and W2 dy^T (K = c, N = 8 rows): plain, rows r0 + 8 nt; B of dW1^T
      // and dW2 (K = 16 rows, N = 8 c): .trans, c-tile pairs.
      uint32_t xf[2][4], df[2][4], xtr[2][4], dtr[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pl = (r0 + 8 * t + lane % 8) * CS + 8 * (lane / 8);
        ldsm_x4(xf[t], xt + pl);
        ldsm_x4(df[t], dt + pl);
        const int tr = (r0 + 8 * ((lane / 8) % 2) + lane % 8) * CS +
                       8 * (2 * t + lane / 16);
        ldsm_x4_trans(xtr[t], xt + tr);
        ldsm_x4_trans(dtr[t], dt + tr);
      }
      float z[MT][2][4], gg[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) z[mt][nt][i] = gg[mt][nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            mma_bf16(z[mt][nt], wa[mt][ks], xf[nt][2 * ks],
                     xf[nt][2 * ks + 1]);
            mma_bf16(gg[mt][nt], wb[mt][ks], df[nt][2 * ks],
                     df[nt][2 * ks + 1]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // C tile (mt, nt): j = J0 + 16 mt + g + 8 hh at registers 2 hh
        // and 2 hh + 1, rows r0 + 8 nt + 2q and + 1: dz = W2 dy masked by
        // z > 0 and h = relu(z), float32, split into A fragments.
        uint32_t adz[3][4], ah[3][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float z0 = z[mt][nt][2 * hh] + bias[mt][hh];
            const float z1 = z[mt][nt][2 * hh + 1] + bias[mt][hh];
            const float dz0 = z0 > 0.f ? gg[mt][nt][2 * hh] : 0.f;
            const float dz1 = z1 > 0.f ? gg[mt][nt][2 * hh + 1] : 0.f;
            const int i = 2 * nt + hh;
            split3_bf16x2(dz0, dz1, adz[0][i], adz[1][i], adz[2][i]);
            split3_bf16x2(fmaxf(z0, 0.f), fmaxf(z1, 0.f), ah[0][i],
                          ah[1][i], ah[2][i]);
            db1a[mt][hh] += dz0 + dz1;
            float* zp = zb + (r0 + 8 * nt + 2 * q) * ZS + J0 + 16 * mt + g +
                        8 * hh;
            zp[0] = dz0;
            zp[ZS] = dz1;
          }
#pragma unroll
        for (int pc = 2; pc >= 0; --pc)   // lo, mid, hi
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma_bf16(acc1[mt][2 * t], adz[pc], xtr[t][0], xtr[t][1]);
            mma_bf16(acc1[mt][2 * t + 1], adz[pc], xtr[t][2], xtr[t][3]);
            mma_bf16(acc2[mt][2 * t], ah[pc], dtr[t][0], dtr[t][1]);
            mma_bf16(acc2[mt][2 * t + 1], ah[pc], dtr[t][2], dtr[t][3]);
          }
      }
      // db2: dy at rows r0 + 2q (+1, +8, +9), c = 8 ct + g; row group rg
      // is summed by warp rg.
      const float on = rg == warp ? 1.f : 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&dtr[t][i]));
          db2a[2 * t + i / 2] = fmaf(on, v.x + v.y, db2a[2 * t + i / 2]);
        }
    }
    __syncthreads();   // this tile's dz complete
#pragma unroll 1
    for (int kp = 0; kp < 8; ++kp) phase_c(kp);
    epilogue(tile);
    if (next < tiles) {
      probav::cp_async_wait_group<0>();   // the next tile's x, dy
      __syncwarp();
      repack(dyt + (buf ^ 1) * ROWS * CS, skew, rows_of(next));
    }
  }
  probav::cp_async_wait_all();

  // Write this block's slot, every entry: dW1, then dW2, staged in the dz
  // space in the slot's order and stored in coalesced runs.
  const Slot sl(c_in, c_mid, c_dec, false);
  float* slot = part + blockIdx.x * slot_len;
  float* sbuf = zb;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();   // the dz space (then sbuf) read
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = J0 + 16 * mt + g + 8 * (i / 2);
          const int c = 8 * ct + 2 * q + (i & 1);
          if (pass == 0 && j < c_mid && c < c_in)
            sbuf[c * c_mid + j] = acc1[mt][ct][i];
          if (pass == 1 && j < c_mid && c < c_dec)
            sbuf[j * c_dec + c] = acc2[mt][ct][i];
        }
    __syncthreads();
    const int len = pass == 0 ? c_in * c_mid : c_mid * c_dec;
    float* dst = slot + (pass == 0 ? sl.w1 : sl.w2);
    for (int e = tid; e < len; e += blockDim.x) dst[e] = sbuf[e];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // db1: lanes q hold rows 2q, 2q + 1 (mod 8) of j; summed in order.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = db1a[mt][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int j = J0 + 16 * mt + g + 8 * hh;
      if (q == 0 && j < c_mid) slot[sl.b1 + j] = v;
    }
  }
#pragma unroll
  for (int ct = 0; ct < 4; ++ct) {   // db2 of this warp's row groups
    float v = db2a[ct];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0) red[warp * 32 + 8 * ct + g] = v;
  }
  __syncthreads();
  if (tid < c_dec) {
    float sum = 0.f;
    for (int w = 0; w < WBB_WARPS; ++w) sum += red[w * 32 + tid];
    slot[sl.b2 + tid] = sum;
  }
}

cudaError_t launch_wide_bwd_bf16(const void* x, const void* w1,
                                 const float* b1, const void* w2,
                                 const void* dy, void* dx, float* part,
                                 long slot_len, int G, int n, int c_in,
                                 int c_mid, int c_dec, int* used,
                                 cudaStream_t s) {
  const size_t smem = wide_bwd_bf16_smem();
  auto kern = wide_bwd_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // One wave: as many blocks as are resident at once (one an SM), each
  // taking every G1-th tile; *used = G1, the slots written (the reduce
  // sums those alone; the rest are neither written nor read).
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, WBB_WARPS * 32, smem);
  if (err != cudaSuccess) return err;
  const int G1 = std::min(G, std::max(1, sms * per_sm));
  *used = G1;
  using B16 = __nv_bfloat16;
  kern<<<G1, WBB_WARPS * 32, smem, s>>>(
      static_cast<const B16*>(x), static_cast<const B16*>(w1), b1,
      static_cast<const B16*>(w2), static_cast<const B16*>(dy),
      static_cast<B16*>(dx), part, slot_len, n, c_in, c_mid, c_dec);
  return cudaGetLastError();
}

// Which kernel wide_bwd runs, from the dtype and widths alone: where the
// tensor cores' tiles cover the widths (c_in, c_dec <= 32, c_mid <= 256)
// bf16 on wide_bwd_bf16_kernel and float32 on wide_bwd_tf32_kernel; beyond,
// seg_bwd_kernel with WIDE (the CUDA cores).
enum WideBwdRoute {
  WIDE_BWD_CUDA_CORES = 0,
  WIDE_BWD_BF16_MMA = 1,
  WIDE_BWD_TF32_MMA = 2
};

WideBwdRoute wide_bwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  if (c_in > 32 || c_dec > 32 || c_mid > 256) return WIDE_BWD_CUDA_CORES;
  return dtype == 1 ? WIDE_BWD_BF16_MMA : WIDE_BWD_TF32_MMA;
}

// ------------------------------------------------------------------------ //
// reduce: out[i] = sum over g < G of part[g * stride + i], i < len:         //
// reduce_partials_kernel.                                                  //
// ------------------------------------------------------------------------ //
//
// The last launch of probav_blk_bwd and probav_wide_bwd: the G float32
// partial slots that kernels 2 and 3 (or wide_bwd's kernel) wrote, summed
// into one.  The JAX package sums its per-tile partials in XLA after its
// kernel (pallas_tstack.py:445-449, pallas_wide_block.py alike), so
// torch.sum(part[:, :len], 0) computes this function too.
//
// Bound on an H100: a pure stream, 4 (G + 1) len bytes at 3.35 TB/s and one
// add a float read: 0.0116 ms for blk_bwd at the flagship (264 slots of
// 36,505), 0.0024 ms for wide_bwd (132 slots of 14,873; 0.0047 ms if it
// read the 264 of its scratch).  The design keeps the card's memory busy:
// - slots start on 128-byte boundaries (the wrappers' stride, a multiple
//   of 32 floats), so a thread owns one float4 column and every load is 16
//   bytes, a warp's 512 contiguous bytes of a slot, read as a stream
//   (ld.global.cs, evict first: at blk_bwd's flagship slots 0.0092 ms from
//   L2 and 0.0183 from DRAM, against 0.0116 and 0.0207 by ld.global.nc;
//   tools/reduce_variants.py, NVIDIA H100 80GB HBM3, 700.00 W);
// - a column tile (128 floats, one warp's float4 row) has its G slots cut
//   into fixed contiguous segments, one per (cluster rank, warp); a warp
//   walks its segment in slot order with RED_AHEAD independent loads
//   issued before their adds, so each SM has tens of KB of loads in
//   flight (bandwidth x latency / 132 SMs is ~30 KB);
// - reduce_plan picks the warps a block (up to 8) and the blocks a
//   thread-block cluster (up to 8, portable) from G and the tile count, so
//   that tiles x clusters fill the 132 SMs with ~RED_FILL warps each (a
//   tile at least RED_MIN_WARPS segments), and no warp has fewer than
//   RED_MIN_SEG slots where G allows;
// - a block's warps meet in shared memory in warp order, the cluster's
//   blocks through distributed shared memory (map_shared_rank) in rank
//   order, and rank 0 stores the tile: one pass, no atomics.
// The order of summation is fixed by (G, len) and the SM count alone:
// slots in order within a segment, segments in order (warps, then ranks).
// So two runs give the same bits, as the JAX package's fixed-order sum
// does.  Columns from len up to the stride are never stored; a float4
// that straddles len sums pad floats in lanes that are not stored.  No TMA:
// with no reuse a stream gains nothing from staging through shared memory,
// and 16-byte register loads already issue one instruction per 512 bytes a
// warp.
constexpr int RED_TILE = 128;       // floats a column tile: 32 lanes x float4
constexpr int RED_AHEAD = 8;        // loads a thread issues before its adds
constexpr int RED_MAX_WARPS = 8;    // warps a block
constexpr int RED_MAX_RANKS = 8;    // blocks a cluster (portable)
constexpr int RED_FILL = 32;        // warps an SM the plan aims at
constexpr int RED_MIN_WARPS = 4;    // fewest segments a tile, where G allows
constexpr int RED_MIN_SEG = 4;      // fewest slots a warp, where G allows

struct ReducePlan {
  int tiles, ranks, warps;   // grid = tiles x ranks blocks of warps x 32
};

// The plan for G slots of len floats on a card of `sms` SMs: segments a
// tile = enough warps to fill the card (at least RED_MIN_WARPS: a wave of
// one-warp blocks holds too few loads in flight), at most G / RED_MIN_SEG
// (at least 1) and 64; as few cluster ranks as hold them at 8 warps a
// block, and as many warps a block as fit that count (ranks x warps <=
// segments).
ReducePlan reduce_plan(int G, long len, int sms) {
  const long tiles = (len + RED_TILE - 1) / RED_TILE;
  const long fill = ((long)sms * RED_FILL + tiles - 1) / tiles;
  long segs = std::min(std::max(fill, (long)RED_MIN_WARPS),
                       (long)std::max(1, G / RED_MIN_SEG));
  segs = std::min(segs, (long)RED_MAX_WARPS * RED_MAX_RANKS);
  const int ranks = (int)((segs + RED_MAX_WARPS - 1) / RED_MAX_WARPS);
  return {(int)tiles, ranks, (int)(segs / ranks)};
}

__device__ __forceinline__ float4 load_part(const float4* p) {
  return __ldcs(p);
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// blockIdx.x = tile * ranks + rank, a cluster of `ranks` blocks a tile.
__global__ void __launch_bounds__(RED_MAX_WARPS * 32)
reduce_partials_kernel(const float* __restrict__ part,
                       float* __restrict__ out, int G, long len,
                       long stride, int ranks) {
  __shared__ float4 wsum[RED_MAX_WARPS][32];
  __shared__ float4 bsum[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int segs = ranks * warps, seg = rank * warps + warp;
  const int g0 = (int)((long)seg * G / segs);
  const int g1 = (int)((long)(seg + 1) * G / segs);
  const long col = (long)(blockIdx.x / ranks) * 32 + lane;   // float4s
  const bool live = col < (len + 3) / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const long step = stride / 4;
    const float4* p =
        reinterpret_cast<const float4*>(part + (long)g0 * stride) + col;
    int g = g0;
    for (; g + RED_AHEAD <= g1; g += RED_AHEAD, p += RED_AHEAD * step) {
      float4 v[RED_AHEAD];
#pragma unroll
      for (int k = 0; k < RED_AHEAD; ++k) v[k] = load_part(p + k * step);
#pragma unroll
      for (int k = 0; k < RED_AHEAD; ++k) add4(s, v[k]);
    }
    float4 v[RED_AHEAD];   // the rest, fewer than RED_AHEAD, issued together
#pragma unroll
    for (int k = 0; k < RED_AHEAD; ++k)
      if (g + k < g1) v[k] = load_part(p + k * step);
#pragma unroll
    for (int k = 0; k < RED_AHEAD; ++k)
      if (g + k < g1) add4(s, v[k]);
  }
  wsum[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float4 t = wsum[0][lane];
    for (int w = 1; w < warps; ++w) add4(t, wsum[w][lane]);
    bsum[lane] = t;
  }
  cluster.sync();
  if (rank == 0 && warp == 0 && live) {
    float4 t = *cluster.map_shared_rank(&bsum[lane], 0);
    for (int r = 1; r < ranks; ++r)
      add4(t, *cluster.map_shared_rank(&bsum[lane], r));
    float* o = out + col * 4;
    if (col * 4 + 4 <= len) {
      *reinterpret_cast<float4*>(o) = t;
    } else {
      const int n = (int)(len - col * 4);
      o[0] = t.x;
      if (n > 1) o[1] = t.y;
      if (n > 2) o[2] = t.z;
    }
  }
  cluster.sync();   // no block leaves while rank 0 reads its bsum
}

// Whether the reduce takes slots of len floats `stride` floats apart: a
// stride that is a multiple of 4 and at least len, part and out 16-byte
// aligned (float4 loads and stores).
bool reduce_takes(const void* part, const void* out, long len,
                  long stride) {
  return len >= 1 && stride >= len && stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// The launch of plan q: tiles x ranks blocks in clusters of ranks.
struct ReduceLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ReduceLaunch(const ReducePlan& q, cudaStream_t s) {
    cfg.gridDim = dim3((unsigned)q.tiles * q.ranks);
    cfg.blockDim = dim3(q.warps * 32);
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = q.ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// cudaErrorInvalidValue, before any launch, where reduce_takes refuses.
cudaError_t reduce_partials(const float* part, float* out, int G, long len,
                            long stride, cudaStream_t s) {
  if (G < 1 || !reduce_takes(part, out, len, stride))
    return cudaErrorInvalidValue;
  const ReducePlan q = reduce_plan(G, len, probav::sm_count());
  ReduceLaunch l(q, s);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, reduce_partials_kernel, part, out, G, len, stride, q.ranks);
  if (err != cudaSuccess) {
    cudaGetLastError();   // returned, not left pending
    return err;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t blk_bwd(int dtype, const void* gy, const void* x, const void* d,
                    const void* wflip, const void* w1, const float* b1,
                    const void* w2, void* dd, void* dx, float* part,
                    float* out, float* dxp, int G, long stride, int B, int H,
                    int W, int Tn, int c_in, int c_mid, int c_dec,
                    cudaStream_t s) {
  const Slot sl(c_in, c_mid, c_dec);
  const int n = B * H * W * Tn;
  cudaError_t err = probav::conv_dispatch(dtype, false, gy, nullptr, wflip,
                                          nullptr, dd, B, H, W, Tn, c_in,
                                          c_dec, s);
  if (err != cudaSuccess) return err;
  switch (wgrad_route(dtype, c_dec, c_in, W, Tn)) {
    case WGRAD_BF16_RING:
      err = launch_wgrad_ring(d, gy, part, stride, G, B, H, W, Tn, c_dec,
                              c_in, s);
      break;
    case WGRAD_BF16_TILES:
      err = launch_wgrad_tiles(d, gy, part, stride, G, B, H, W, Tn, c_dec,
                               c_in, s);
      break;
    case WGRAD_TF32_RING:
      err = launch_wgrad_tf32(d, gy, part, stride, G, B, H, W, Tn, c_dec,
                              c_in, s);
      break;
    case WGRAD_TF32_TILES:
      err = launch_wgrad_tf32_tiles(d, gy, part, stride, G, B, H, W, Tn,
                                    c_dec, c_in, s);
      break;
    default:
      err = dispatch_wgrad<T>(d, gy, part, stride, G, B, H, W, Tn, c_dec,
                              c_in, s);
  }
  if (err != cudaSuccess) return err;
  switch (seg_bwd_route(dtype, c_in, c_mid, c_dec)) {
    case SEG_BWD_BF16_MMA:
      err = launch_seg_bwd_bf16(x, dd, gy, w1, b1, w2, dx, part, stride, G,
                                n, c_in, c_mid, c_dec, s);
      break;
    case SEG_BWD_TF32_MMA:
      err = launch_seg_bwd_tf32(x, dd, gy, w1, b1, w2, dx, part, stride, G,
                                n, c_in, c_mid, c_dec, s);
      break;
    case SEG_BWD_BF16_SPLIT:
      err = launch_seg_bwd_split(x, dd, gy, w1, b1, w2, dx, dxp, part,
                                 stride, G, n, c_in, c_mid, c_dec, s);
      break;
    case SEG_BWD_TF32_SPLIT:
      err = launch_seg_bwd_tf32_split(x, dd, gy, w1, b1, w2, dx, dxp, part,
                                      stride, G, n, c_in, c_mid, c_dec, s);
      break;
    default:
      err = dispatch_seg_bwd<T>(x, dd, gy, w1, b1, w2, dx, part, stride, G,
                                n, c_in, c_mid, c_dec, s);
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, G, sl.len, stride, s);
}

template <typename T>
cudaError_t wide_bwd(const void* x, const void* w1, const float* b1,
                     const void* w2, const void* dy, void* dx, float* part,
                     float* out, int G, long stride, int n, int c_in,
                     int c_mid, int c_dec, cudaStream_t s) {
  const Slot sl(c_in, c_mid, c_dec, false);
  constexpr int dtype = std::is_same<T, __nv_bfloat16>::value ? 1 : 0;
  cudaError_t err;
  int used = G;   // the slots written, the first `used` of the G
  switch (wide_bwd_route(dtype, c_in, c_mid, c_dec)) {
    case WIDE_BWD_BF16_MMA:
      err = launch_wide_bwd_bf16(x, w1, b1, w2, dy, dx, part, stride, G, n,
                                 c_in, c_mid, c_dec, &used, s);
      break;
    case WIDE_BWD_TF32_MMA:
      err = launch_wide_bwd_tf32(x, w1, b1, w2, dy, dx, part, stride, G, n,
                                 c_in, c_mid, c_dec, &used, s);
      break;
    default:
      err = dispatch_seg_bwd<T, true>(x, dy, nullptr, w1, b1, w2, dx, part,
                                      stride, G, n, c_in, c_mid, c_dec, s);
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, used, sl.len, stride, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  gy, x [B,H,W,T,c_in], d [B,H,W,T,
// c_dec], w1 [c_in, c_mid], w2 [c_mid, c_dec] and the scratch dd [B,H,W,T,
// c_dec] and output dx [B,H,W,T,c_in] in that dtype; wflip [3,3,3,c_in,
// c_dec] in that dtype is wc [3,3,3,c_dec,c_in] flipped in its three tap
// axes with its channel axes swapped; b1 float32.  part: float32 scratch
// of G slots `stride` floats apart (a multiple of 4, at least slot_len),
// 16-byte aligned; out: float32 [slot_len] in the Slot layout above,
// 16-byte aligned; dxp: float32 scratch of probav_blk_bwd_scratch's
// floats, 16-byte aligned (null where that is 0).  c_in and c_dec any
// count from 1 to MAX_CH = 128; T within the dd conv's envelope (tstack.cu,
// conv_ring_kernel), else cudaErrorInvalidValue before any launch.
int probav_blk_bwd(int dtype, const void* gy, const void* x, const void* d,
                   const void* wflip, const void* w1, const void* b1,
                   const void* w2, void* dd, void* dx, void* part, void* out,
                   void* dxp, int G, int stride, int B, int H, int W, int Tn,
                   int c_in, int c_mid, int c_dec, void* stream) {
  const long scratch = seg_bwd_scratch(dtype, c_in, c_mid, c_dec,
                                       (long)B * H * W * Tn);
  if (B < 1 || H < 1 || W < 1 || Tn < 1 || G < 1 || c_in < 1 ||
      c_in > probav::MAX_CH || c_dec < 1 || c_dec > probav::MAX_CH ||
      c_mid < 1 ||
      !reduce_takes(part, out, Slot(c_in, c_mid, c_dec).len, stride) ||
      (scratch > 0 && (dxp == nullptr ||
                       reinterpret_cast<uintptr_t>(dxp) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  float* xf = static_cast<float*>(dxp);
  if (dtype == 0)
    return (int)blk_bwd<float>(0, gy, x, d, wflip, w1, b1f, w2, dd, dx, pf,
                               of, xf, G, stride, B, H, W, Tn, c_in, c_mid,
                               c_dec, s);
  if (dtype == 1)
    return (int)blk_bwd<__nv_bfloat16>(1, gy, x, d, wflip, w1, b1f, w2, dd,
                                       dx, pf, of, xf, G, stride, B, H, W,
                                       Tn, c_in, c_mid, c_dec, s);
  return (int)cudaErrorInvalidValue;
}

// *out = the floats of the dxp scratch probav_blk_bwd needs at these
// widths and n rows (0: none).
int probav_blk_bwd_scratch(int dtype, int c_in, int c_mid, int c_dec, int n,
                           long long* out) {
  if (n < 0 || c_in < 1 || c_mid < 1 || c_dec < 1)
    return (int)cudaErrorInvalidValue;
  *out = seg_bwd_scratch(dtype, c_in, c_mid, c_dec, n);
  return 0;
}

// The seg_bwd kernel probav_blk_bwd launches for these widths: 0 =
// seg_bwd_kernel (CUDA cores), 1 = seg_bwd_bf16_kernel (bf16 mma), 2 =
// seg_bwd_tf32_kernel (float32 as 3xTF32 mma), 3 = seg_bwd_split_kernel
// then dx_sum_kernel (bf16 mma, c_mid in chunks of 256), 4 =
// seg_bwd_tf32_split_kernel then dx_sum_kernel (float32 as 3xTF32 mma,
// c_mid in chunks of 128).
int probav_seg_bwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  return (int)seg_bwd_route(dtype, c_in, c_mid, c_dec);
}

// The wgrad (dWc) kernel probav_blk_bwd launches for these shapes: 0 =
// wgrad_kernel (CUDA cores), 1 = wgrad_ring_kernel (bf16 mma), 2 =
// wgrad_tf32_kernel (float32 as 3xTF32 mma), 3 = wgrad_tiles_kernel (bf16
// mma, 32 x 32 channel tiles), 4 = wgrad_tf32_tiles_kernel (float32 as
// 3xTF32 mma, 32 x 32 channel tiles).
int probav_wgrad_route(int dtype, int c_in, int c_dec, int W, int Tn) {
  return (int)wgrad_route(dtype, c_dec, c_in, W, Tn);
}

// dtype: 0 = float32, 1 = bfloat16.  x [n, c_in], w1 [c_in, c_mid], w2
// [c_mid, c_dec], dy [n, c_dec] and the output dx [n, c_in] in that dtype;
// b1 float32.  part: float32 scratch of G slots `stride` floats apart (a
// multiple of 4, at least slot_len), 16-byte aligned, of which the kernel
// may write and the reduce read fewer (one wave of the tensor-core
// kernels' blocks); out: float32 dW1 [c_in][c_mid] | dW2 [c_mid][c_dec] |
// db1 [c_mid] | db2 [c_dec], 16-byte aligned.  c_in and c_dec any count
// from 1 to MAX_CH = 128.
int probav_wide_bwd(int dtype, const void* x, const void* w1, const void* b1,
                    const void* w2, const void* dy, void* dx, void* part,
                    void* out, int G, int stride, int n, int c_in, int c_mid,
                    int c_dec, void* stream) {
  if (n < 1 || G < 1 || c_in < 1 || c_in > probav::MAX_CH || c_dec < 1 ||
      c_dec > probav::MAX_CH || c_mid < 1 ||
      !reduce_takes(part, out, Slot(c_in, c_mid, c_dec, false).len,
                    stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (dtype == 0)
    return (int)wide_bwd<float>(x, w1, b1f, w2, dy, dx, pf, of, G, stride, n,
                                c_in, c_mid, c_dec, s);
  if (dtype == 1)
    return (int)wide_bwd<__nv_bfloat16>(x, w1, b1f, w2, dy, dx, pf, of, G,
                                        stride, n, c_in, c_mid, c_dec, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel probav_wide_bwd launches for these widths: 0 = seg_bwd_kernel
// with WIDE (CUDA cores), 1 = wide_bwd_bf16_kernel (bf16 mma, float32
// operands split three ways), 2 = wide_bwd_tf32_kernel (float32 as 3xTF32
// mma).
int probav_wide_bwd_route(int dtype, int c_in, int c_mid, int c_dec) {
  return (int)wide_bwd_route(dtype, c_in, c_mid, c_dec);
}

// out[i] = sum over g < G of part[g * stride + i] for i < len, the last
// launch of probav_blk_bwd and probav_wide_bwd on its own (for tests and
// timing; the entries launch it themselves).  part float32, 16-byte
// aligned, stride a multiple of 4 and at least len; out float32 [len],
// 16-byte aligned; else cudaErrorInvalidValue before any launch.
int probav_reduce_partials(const void* part, void* out, int G, int len,
                           int stride, void* stream) {
  return (int)reduce_partials(static_cast<const float*>(part),
                              static_cast<float*>(out), G, len, stride,
                              static_cast<cudaStream_t>(stream));
}

// The reduce's launch for G slots of len floats on this card: out[0..2] =
// column tiles, blocks a cluster (ranks), warps a block; out[3] = the
// clusters of that shape the card holds at once
// (cudaOccupancyMaxActiveClusters).
int probav_reduce_partials_plan(int G, int len, int* out) {
  if (G < 1 || len < 1) return (int)cudaErrorInvalidValue;
  const ReducePlan q = reduce_plan(G, len, probav::sm_count());
  ReduceLaunch l(q, nullptr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, reduce_partials_kernel, &l.cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  out[0] = q.tiles;
  out[1] = q.ranks;
  out[2] = q.warps;
  out[3] = clusters;
  return 0;
}

}  // extern "C"
