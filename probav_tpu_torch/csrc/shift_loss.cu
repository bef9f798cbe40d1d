// Hand-written Hopper kernels for the 49-shift loss table and its backward.
//
// Replace the TPU kernels _pallas_table_2d (probav_tpu/ops/
// pallas_shift_loss.py:108, body _fwd_kernel :51) and _pallas_table_bwd_2d
// (:126, body _bwd_kernel :73).  For each sample and each shift (i, j) of
// the ground truth within +-border, over the crop x crop window:
//
//   total = sum m,  bias = (sum hr - sum p*m) / total
//   r     = hr - (p + bias) * m                      (p: the centre crop)
//   L     = sum |r| / total     or    sum r^2 / total
//
// and the backward, the analytic dL/dp with the bias term included:
//
//   dp = sum_s g_s * (-phi_s * m_s + m_s * sum(phi_s * m_s) / total_s)
//        / total_s,   phi = sign(r) (L1) or 2 r (L2),
//
// zero on the border outside the crop.  float32 only, as the TPU kernel.
//
// Design.  The bias makes three phases: A, the per-shift sums of m, hr
// and p*m over the whole window; B, with the bias, sum |r| or r^2 (the
// forward) or sum phi*m (the backward); C, backward only, d/dp per pixel,
// the shifts summed in shift order.  The backward recomputes A and B, as
// the TPU kernel does.  Both run in one launch per call:
//
// - A thread-block cluster per sample splits the crop rows into bands, one
//   a block.  plan_for() picks the cluster size (1 to 16) whose blocks
//   take the fewest rows, counting the waves of clusters that the card
//   holds at once (a cluster lives in one GPC, so at 16 scenes of 384^2
//   the card holds 17 clusters of 6 blocks and 15 of 8: 6 bands of 63
//   rows fill 96 SMs in one wave; 128 patches of 48^2 take a block each).
//   A block stages its band's hr and m rows, with their 2*border-row halo,
//   as (hr, m) pairs in shared memory (in row tiles, and column tiles,
//   where a band does not fit); p is read from device memory through L1,
//   each value by the 2*border+1 warps of its shift columns.
// - Phases A and B: a warp takes one shift column j and a group of up to
//   7 shift rows i (and one of P parts of the items), a lane an item: one
//   crop column x by 8 crop rows.  It loads the item's 14 (hr, m) pairs
//   once and keeps the 7 shift rows' sums in registers, so each pair
//   feeds up to 7 shifts and each p value 7 (p once per shift column, not
//   once per shift; the next item's p is loaded while one runs).  In phase
//   A the totals of m and hr of an item's 7 shift rows are sliding sums
//   down its 14 rows.  The lanes' sums meet by warp shuffles, the parts in
//   part order, the tiles in tile order.
// - The bands meet through distributed shared memory: each block leaves
//   its band's sums in its own shared memory, cluster.sync(), and every
//   block reads ranks 0..n-1 in rank order, so all blocks hold the same
//   totals bit for bit.  No float atomics: a run is deterministic.
// - Phase C: a thread takes one crop row and 7 columns; per shift row it
//   loads 13 (hr, m) pairs and runs the 7 shift columns on them, the
//   per-shift constants (bias, c k, and k or -2k with c = sum phi m /
//   total, k = g / total) broadcast from shared memory.
// - No division in the inner loops; float32 on the CUDA cores (the work
//   is elementwise with reductions: the tensor cores offer no lever).
//
// What bounds it on an H100 (chip_smoke.shift_costs: the least work,
// with the windows' sums of m and hr as box sums): at B = 128, 48 x 48,
// border 3, the forward needs 7 FLOP per pixel and shift over 49 x 42 x
// 42 windows (0.079 GFLOP, 1.2 us at the 67 TFLOP/s float32 peak; the
// inputs are 3.6 MB, 1.1 us at 3.35 TB/s), the backward 16 (0.18 GFLOP,
// 2.7 us); at B = 16, 384 x 384 the forward is 0.79 GFLOP (11.8 us) and
// 28.3 MB (8.5 us), the backward 1.80 GFLOP (26.9 us).  So operations
// bound both, and at 48^2 a launch (~3 us) costs more than either.

#include "common.cuh"

#include <algorithm>
#include <climits>
#include <mutex>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SR = 7;          // shift rows of a warp's group (A, B)
constexpr int QR = 8;          // crop rows of an item (A, B)
constexpr int KC = 7;          // crop columns of an item (C)
constexpr int SJ = 7;          // shift columns of a window (C)
constexpr int MAX_BANDS = 16;  // blocks of a cluster (8 is portable)
constexpr int MAX_WARPS = 16;  // warps of a block
constexpr int WIN = QR + SR - 1;
constexpr int CWIN = KC + SJ - 1;

// The launch plan of one call: its grid, its tiles and its shared memory.
struct Plan {
  int H, W, border, n, S, ch, cw;
  int nb, R;    // blocks of a sample's cluster, crop rows of a band
  int RT, CT;   // crop rows and crop columns of a tile
  int G, P;     // groups of shift rows, parts of the items
  int NW;       // warps of a block
  int stride;   // floats of a staged row: CT + 2 border, made odd
  int smem;     // bytes of dynamic shared memory
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Floats of shared memory before the staged tile: cst [S][4], part
// [P][3][S], bandA [3][S], bandB [S], rounded up to 4 (16 bytes).
__host__ __device__ __forceinline__ int fixed_floats(int P, int S) {
  return ((8 + 3 * P) * S + 3) & ~3;
}

// The plan for [B, H, W] planes in clusters of (up to) `nb` blocks, with
// `optin` bytes of shared memory a block; false where the kernels refuse
// the planes.
bool plan(int B, int H, int W, int border, int nb, int optin, Plan& q) {
  if (B < 1 || border < 0 || H <= 2 * border || W <= 2 * border ||
      (long long)H * W > INT_MAX)
    return false;
  q.H = H, q.W = W, q.border = border;
  q.n = 2 * border + 1, q.S = q.n * q.n;
  q.ch = H - 2 * border, q.cw = W - 2 * border;
  q.G = ceil_div(q.n, SR);
  q.P = std::max(1, MAX_WARPS / (q.n * q.G));
  q.NW = std::min(q.n * q.G * q.P, MAX_WARPS);
  // Bands: none of them empty.
  q.nb = std::min(nb, q.ch);
  q.R = ceil_div(q.ch, q.nb);
  q.nb = ceil_div(q.ch, q.R);
  if ((long long)q.nb * B > INT_MAX) return false;
  // Shared memory: cst [4 S], part [P][3][S], bandA [3][S], bandB [S],
  // then the (hr, m) pairs of a tile.
  const long long fixed = fixed_floats(q.P, q.S);
  const long long avail = optin / 4 - fixed;
  if (avail <= 0) return false;
  const int halo = 2 * border;
  auto rows_fit = [&](int cols) {
    return avail / (2 * ((cols + halo) | 1)) - halo;
  };
  // Whole crop rows where 8 (or the band's) fit, else halves of them.
  q.CT = q.cw;
  long long rows = rows_fit(q.CT);
  while (rows < std::min(q.R, QR) && q.CT > 1)
    rows = rows_fit(q.CT = ceil_div(q.CT, 2));
  if (rows < 1) return false;
  q.RT = (int)std::min<long long>(q.R, rows);
  q.stride = (q.CT + halo) | 1;
  q.smem = (int)(4 * (fixed + 2LL * (q.RT + halo) * q.stride));
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane adds the same pairs, so all lanes agree exactly.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The barrier between the bands of a sample: the cluster's, or the
// block's where one block takes the sample.
__device__ __forceinline__ void sync_bands(const cg::cluster_group& cluster,
                                           int nb) {
  if (nb > 1)
    cluster.sync();
  else
    __syncthreads();
}

// A tile of a band: crop rows [y0, y0 + rt), crop columns [x0, x0 + ct).
struct Tile {
  int y0, x0, rt, ct;
};

__device__ __forceinline__ Tile tile_of(const Plan& q, int band0, int band1,
                                        int t) {
  const int ntx = ceil_div(q.cw, q.CT);
  Tile u;
  u.y0 = band0 + (t / ntx) * q.RT;
  u.x0 = (t % ntx) * q.CT;
  u.rt = min(q.RT, band1 - u.y0);
  u.ct = min(q.CT, q.cw - u.x0);
  return u;
}

// Stage the tile's hr and m as (hr, m) pairs: plane rows [y0, y0 + rt +
// 2 border), plane columns [x0, x0 + ct + 2 border), by 4-byte cp.async
// (rows of any alignment); a warp per row.
__device__ __forceinline__ void stage(const Plan& q, const Tile& u,
                                      const float* __restrict__ hr,
                                      const float* __restrict__ m,
                                      float2* hm) {
  const int rows = u.rt + 2 * q.border, cols = u.ct + 2 * q.border;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += q.NW) {
    const float* hrow = hr + (u.y0 + r) * q.W + u.x0;
    const float* mrow = m + (u.y0 + r) * q.W + u.x0;
    for (int c = lane; c < cols; c += 32) {
      float* d = reinterpret_cast<float*>(hm + r * q.stride + c);
      probav::cp_async4_zfill(d, hrow + c, true);
      probav::cp_async4_zfill(d + 1, mrow + c, true);
    }
  }
  probav::cp_async_wait_all();
}

// p of an item's rows (zeros past the tile, or past the items).
__device__ __forceinline__ void load_p(float (&pv)[QR], const Plan& q,
                                       const Tile& u,
                                       const float* __restrict__ pc,
                                       int nq, int chunk, int xl) {
  const int nqv = chunk < nq ? min(QR, u.rt - chunk * QR) : 0;
  const float* pp = pc + (u.y0 + chunk * QR) * q.W + u.x0 + xl;
#pragma unroll
  for (int r = 0; r < QR; ++r) pv[r] = r < nqv ? __ldg(pp + r * q.W) : 0.f;
}

// v sign(r) for r != 0: v with its sign bit flipped where r's is set (one
// logic instruction; the compare-and-select form takes four on the
// half-rate ALU pipe).
__device__ __forceinline__ float times_sign(float v, float r) {
  return __int_as_float(__float_as_int(v) ^ (__float_as_int(r) & INT_MIN));
}

// Phase B's term of one pixel and shift into acc.
template <bool BWD, bool SQ>
__device__ __forceinline__ float term_b(float acc, float p, float bias,
                                        float2 w) {
  const float res = fmaf(-(p + bias), w.y, w.x);
  if constexpr (BWD && SQ) return fmaf(res, w.y, acc);
  if constexpr (BWD) return acc + (res == 0.f ? 0.f : times_sign(w.y, res));
  if constexpr (SQ) return fmaf(res, res, acc);
  return acc + fabsf(res);
}

// Phases A (PHASE 0) and B (PHASE 1) over one tile: each warp's units
// (shift column j, group of shift rows, part), its lanes over the items,
// the next item's p loaded while one runs; the sums added into
// part[part][quantity][shift].
//   A: quantities total, sum hr, sum p m (an item of 8 rows and 7 shift
//      rows takes the totals as sliding sums down its 14 rows);
//   B: sum |r| or r^2 (forward), sum phi m (backward; 2 r m summed as r m,
//      doubled by the caller).
template <int PHASE, bool BWD, bool SQ>
__device__ __forceinline__ void sweep(const Plan& q, const Tile& u,
                                      const float2* hm,
                                      const float* __restrict__ pc,
                                      const float* cst, float* part) {
  constexpr int NQ = PHASE == 0 ? 3 : 1;
  const int lane = threadIdx.x % 32;
  const int units = q.n * q.G * q.P;
  const int nq = ceil_div(u.rt, QR);
  const int step = 32 * q.P;
  const int dc = step / u.ct, dx = step % u.ct;
  for (int unit = threadIdx.x / 32; unit < units; unit += q.NW) {
    const int j = unit % q.n, ig = (unit / q.n) % q.G;
    const int pt = unit / (q.n * q.G);
    const int i0 = ig * SR, ni = min(SR, q.n - i0);
    float bias[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      bias[i] = (PHASE == 1 && i < ni) ? cst[4 * ((i0 + i) * q.n + j)] : 0.f;
    float acc[NQ][SR];
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int i = 0; i < SR; ++i) acc[k][i] = 0.f;

    const int e0 = pt * 32 + lane;
    int chunk = e0 / u.ct, xl = e0 - chunk * u.ct;
    float pv[QR];
    load_p(pv, q, u, pc, nq, chunk, xl);
    while (chunk < nq) {
      const int yl = chunk * QR;
      const int nqv = min(QR, u.rt - yl);
      const float2* hp = hm + (yl + i0) * q.stride + xl + j;
      int xn = xl + dx, cn = chunk + dc;
      if (xn >= u.ct) {
        xn -= u.ct;
        ++cn;
      }
      float pn[QR];
      load_p(pn, q, u, pc, nq, cn, xn);
      float2 w[WIN];
      if (nqv == QR && ni == SR) {
#pragma unroll
        for (int k = 0; k < WIN; ++k) w[k] = hp[k * q.stride];
        if constexpr (PHASE == 0) {
          float t = 0.f, h = 0.f;
#pragma unroll
          for (int r = 0; r < QR; ++r) {
            t += w[r].y;
            h += w[r].x;
          }
#pragma unroll
          for (int i = 0; i < SR; ++i) {
            if (i > 0) {
              t = t + w[i + QR - 1].y - w[i - 1].y;
              h = h + w[i + QR - 1].x - w[i - 1].x;
            }
            acc[0][i] += t;
            acc[1][i] += h;
#pragma unroll
            for (int r = 0; r < QR; ++r)
              acc[2][i] = fmaf(pv[r], w[r + i].y, acc[2][i]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < QR; ++r)
#pragma unroll
            for (int i = 0; i < SR; ++i)
              acc[0][i] = term_b<BWD, SQ>(acc[0][i], pv[r], bias[i], w[r + i]);
        }
      } else {
        // The last item of a tile's rows, or a group of fewer shift rows.
        const int nk = nqv + ni - 1;
#pragma unroll
        for (int k = 0; k < WIN; ++k)
          w[k] = k < nk ? hp[k * q.stride] : make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < QR; ++r) {
          if (r < nqv) {
#pragma unroll
            for (int i = 0; i < SR; ++i) {
              if constexpr (PHASE == 0) {
                acc[0][i] += w[r + i].y;
                acc[1][i] += w[r + i].x;
                acc[2][i] = fmaf(pv[r], w[r + i].y, acc[2][i]);
              } else {
                acc[0][i] = term_b<BWD, SQ>(acc[0][i], pv[r], bias[i],
                                            w[r + i]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) pv[r] = pn[r];
      xl = xn;
      chunk = cn;
    }
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float v = warp_sum(acc[k][i]);
        if (lane == 0 && i < ni)
          part[(pt * NQ + k) * q.S + (i0 + i) * q.n + j] += v;
      }
  }
}

// Phase C over one tile: d/dp of its crop pixels, each summing the shifts'
// terms in shift order; cst[s] = (bias, v, a, -): L2 e = a r + v, L1 e =
// v - a sign(r), and the term m e.
template <bool SQ>
__device__ __forceinline__ void sweep_dp(const Plan& q, const Tile& u,
                                         const float2* hm,
                                         const float* __restrict__ pc,
                                         const float4* cst,
                                         float* __restrict__ dpc) {
  const int nseg = ceil_div(u.ct, KC);
  const int threads = q.NW * 32;
  const int tx_n = min(nseg, threads), ty_n = threads / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  if (ty >= ty_n) return;
  for (int yl = ty; yl < u.rt; yl += ty_n) {
    for (int xs = tx; xs < nseg; xs += tx_n) {
      const int xl = xs * KC, nkv = min(KC, u.ct - xl);
      const float* pp = pc + (u.y0 + yl) * q.W + u.x0 + xl;
      float pv[KC], acc[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        pv[k] = k < nkv ? __ldg(pp + k) : 0.f;
        acc[k] = 0.f;
      }
      for (int i = 0; i < q.n; ++i) {
        const float2* row = hm + (yl + i) * q.stride + xl;
        for (int j0 = 0; j0 < q.n; j0 += SJ) {
          const int nj = min(SJ, q.n - j0), ncol = nkv + nj - 1;
          float2 w[CWIN];
#pragma unroll
          for (int c = 0; c < CWIN; ++c)
            w[c] = c < ncol ? row[j0 + c] : make_float2(0.f, 0.f);
          const float4* cs = cst + i * q.n + j0;
#pragma unroll
          for (int jj = 0; jj < SJ; ++jj) {
            if (jj < nj) {
              const float4 c4 = cs[jj];
#pragma unroll
              for (int k = 0; k < KC; ++k) {
                const float mv = w[k + jj].y;
                const float res = fmaf(-(pv[k] + c4.x), mv, w[k + jj].x);
                const float e =
                    SQ ? fmaf(c4.z, res, c4.y)
                       : (res == 0.f ? c4.y : c4.y - times_sign(c4.z, res));
                acc[k] = fmaf(mv, e, acc[k]);
              }
            }
          }
        }
      }
      float* out = dpc + (u.y0 + yl) * q.W + u.x0 + xl;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (k < nkv) out[k] = acc[k];
    }
  }
}

// One sample's band: blockIdx.x = sample * nb + rank, a cluster of nb
// blocks per sample.  out: the [B, S] table (forward) or d/dp [B, H, W]
// (backward, with g [B, S]).
template <bool BWD, bool SQ>
__global__ void __launch_bounds__(MAX_WARPS * 32)
shift_table_kernel(const float* __restrict__ hr, const float* __restrict__ m,
                   const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ out, const Plan q) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / q.nb;
  const int S = q.S, border = q.border;
  float* cst = smem;                   // [S][4]
  float* part = cst + 4 * S;           // [P][3][S]
  float* bandA = part + 3 * q.P * S;   // [3][S]
  float* bandB = bandA + 3 * S;        // [S]
  // [RT + 2 border][stride] (hr, m) pairs, after the fixed part rounded
  // up to 4 floats.
  float2* hm = reinterpret_cast<float2*>(smem + fixed_floats(q.P, S));

  const long off = (long)b * q.H * q.W;
  hr += off;
  m += off;
  p += off;
  const float* pc = p + border * q.W + border;   // the crop's origin
  const int band0 = rank * q.R, band1 = min(band0 + q.R, q.ch);
  const int ntiles = ceil_div(band1 - band0, q.RT) * ceil_div(q.cw, q.CT);
  const int tid = threadIdx.x, threads = q.NW * 32;

  if constexpr (BWD) {
    // The border of d/dp: this band's rows outside the crop's columns, and
    // the rows above (rank 0) and below (the last rank) the crop.
    float* dp = out + off;
    const int r0 = rank == 0 ? 0 : border + band0;
    const int r1 = rank == q.nb - 1 ? q.H : border + band1;
    for (int r = r0 + tid / 32; r < r1; r += q.NW) {
      const bool whole = r < border || r >= border + q.ch;
      for (int c = tid % 32; c < q.W; c += 32)
        if (whole || c < border || c >= border + q.cw) dp[r * q.W + c] = 0.f;
    }
  }

  // Phase A.
  for (int e = tid; e < 3 * q.P * S; e += threads) part[e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const Tile u = tile_of(q, band0, band1, t);
    __syncthreads();
    stage(q, u, hr, m, hm);
    __syncthreads();
    sweep<0, BWD, SQ>(q, u, hm, pc, cst, part);
  }
  __syncthreads();
  for (int e = tid; e < 3 * S; e += threads) {
    float v = 0.f;
    for (int k = 0; k < q.P; ++k) v += part[3 * k * S + e];
    bandA[e] = v;
  }
  sync_bands(cluster, q.nb);
  for (int s = tid; s < S; s += threads) {
    float tot = 0.f, sh = 0.f, spm = 0.f;
    for (int r = 0; r < q.nb; ++r) {
      const float* rb = cluster.map_shared_rank(bandA, r);
      tot += rb[s];
      sh += rb[S + s];
      spm += rb[2 * S + s];
    }
    cst[4 * s] = (sh - spm) / tot;   // bias
    cst[4 * s + 1] = tot;
  }
  for (int e = tid; e < q.P * S; e += threads) part[e] = 0.f;
  __syncthreads();

  // Phase B.
  for (int t = 0; t < ntiles; ++t) {
    const Tile u = tile_of(q, band0, band1, t);
    if (ntiles > 1) {
      __syncthreads();
      stage(q, u, hr, m, hm);
      __syncthreads();
    }
    sweep<1, BWD, SQ>(q, u, hm, pc, cst, part);
  }
  __syncthreads();
  for (int s = tid; s < S; s += threads) {
    float v = 0.f;
    for (int k = 0; k < q.P; ++k) v += part[k * S + s];
    bandB[s] = v;
  }
  sync_bands(cluster, q.nb);

  if constexpr (!BWD) {
    if (rank == 0) {
      for (int s = tid; s < S; s += threads) {
        float v = 0.f;
        for (int r = 0; r < q.nb; ++r) v += cluster.map_shared_rank(bandB, r)[s];
        out[(long)b * S + s] = v / cst[4 * s + 1];
      }
    }
    sync_bands(cluster, q.nb);   // no block leaves while rank 0 reads
    return;
  }

  // The per-shift constants of phase C.
  for (int s = tid; s < S; s += threads) {
    float v = 0.f;
    for (int r = 0; r < q.nb; ++r) v += cluster.map_shared_rank(bandB, r)[s];
    if (SQ) v *= 2.f;
    const float tot = cst[4 * s + 1];
    const float c = v / tot, k = g[(long)b * S + s] / tot;
    const float ck = c * k;
    cst[4 * s + 1] = ck;
    cst[4 * s + 2] = SQ ? -2.f * k : k;
  }
  __syncthreads();

  // Phase C.
  float* dpc = out + off + border * q.W + border;
  for (int t = 0; t < ntiles; ++t) {
    const Tile u = tile_of(q, band0, band1, t);
    if (ntiles > 1) {
      __syncthreads();
      stage(q, u, hr, m, hm);
      __syncthreads();
    }
    sweep_dp<SQ>(q, u, hm, pc, reinterpret_cast<const float4*>(cst), dpc);
  }
  sync_bands(cluster, q.nb);   // no block leaves while others read
}

// What the C entries return, before any launch, where plan() refuses the
// planes at every cluster size: a code of their own (CUDA's are >= 0), so
// that a refusal is never taken for a launch's error, nor one for it.
constexpr int REFUSED = -1;

// The kernel's attributes on the current device: the opt-in shared
// memory, and clusters beyond the portable 8 blocks.
template <bool BWD, bool SQ>
cudaError_t configure(int optin) {
  auto kern = shift_table_kernel<BWD, SQ>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The launch of plan q over B samples: B clusters of q.nb blocks.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(const Plan& q, int B, cudaStream_t s) {
    cfg.gridDim = dim3(q.nb * B);
    cfg.blockDim = dim3(q.NW * 32);
    cfg.dynamicSmemBytes = q.smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = q.nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The plan of a launch of kernel <BWD, SQ> on the current device: of the
// cluster sizes 1 to MAX_BANDS, the one whose blocks take the fewest crop
// rows, counting the waves of clusters that the card holds at once
// (cudaOccupancyMaxActiveClusters) and QR rows a block for its fixed
// work; the smaller size where two cost the same.  0, REFUSED, or the CUDA
// error of the attributes or of every occupancy query.  Plans and
// refusals are kept for the last (device, shape)s asked, so a call
// configures the kernel and queries the card only for a new one.
template <bool BWD, bool SQ>
int plan_for(int B, int H, int W, int border, Plan& q) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  struct Entry {
    int dev = -1, B = 0, H = 0, W = 0, border = -1;
    int code = REFUSED;
    Plan q;
  };
  static Entry cache[8];
  static int next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.dev == dev && e.B == B && e.H == H && e.W == W &&
        e.border == border) {
      q = e.q;
      return e.code;
    }
  const int optin = probav::optin_smem();
  err = configure<BWD, SQ>(optin);
  if (err != cudaSuccess) return err;
  Entry e;
  e.dev = dev, e.B = B, e.H = H, e.W = W, e.border = border;
  long long best = LLONG_MAX;
  cudaError_t query = cudaSuccess;
  bool answered = false;
  for (int nb = 1; nb <= MAX_BANDS; ++nb) {
    Plan c;
    if (!plan(B, H, W, border, nb, optin, c) || c.nb != nb) continue;
    Launch l(c, B, nullptr);
    int clusters = 0;
    const cudaError_t r = cudaOccupancyMaxActiveClusters(
        &clusters, shift_table_kernel<BWD, SQ>, &l.cfg);
    if (r != cudaSuccess) {
      cudaGetLastError();   // the query's own error, left pending by it
      query = r;
      continue;
    }
    answered = true;
    if (clusters < 1) continue;
    const long long cost = (long long)ceil_div(B, clusters) * (c.R + QR);
    if (cost < best) {
      best = cost;
      e.q = c;
      e.code = 0;
    }
  }
  if (!answered && query != cudaSuccess) return query;
  cache[next++ % 8] = e;
  q = e.q;
  return e.code;
}

// One call: its plan, then one launch of B clusters; REFUSED, before any
// launch, where the plan refuses the planes.
template <bool BWD, bool SQ>
int launch(int B, int H, int W, int border, cudaStream_t s,
           const float* hr, const float* m, const float* p, const float* g,
           float* out) {
  Plan q;
  const int code = plan_for<BWD, SQ>(B, H, W, border, q);
  if (code != 0) return code;
  Launch l(q, B, s);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, shift_table_kernel<BWD, SQ>, hr, m, p, g, out, q);
  if (err != cudaSuccess) cudaGetLastError();   // returned, not left pending
  return err;
}

}  // namespace

extern "C" {

// hr, m, p: float32 [B, H, W]; out: float32 [B, (2 border + 1)^2], the
// shifts row-major over (i, j).  squared: 0 for L1, 1 for L2.
// REFUSED (-1), before any launch, where plan() refuses the planes.
int probav_shift_table_fwd(const void* hr, const void* m, const void* p,
                           void* out, int B, int H, int W, int border,
                           int squared, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto o = static_cast<float*>(out);
  return squared ? launch<false, true>(B, H, W, border, s, f(hr), f(m), f(p),
                                      nullptr, o)
                 : launch<false, false>(B, H, W, border, s, f(hr), f(m), f(p),
                                        nullptr, o);
}

// As above, with g: float32 [B, S], the cotangent of the table, and dp:
// float32 [B, H, W], the gradient of sum(g * table) with respect to p.
int probav_shift_table_bwd(const void* hr, const void* m, const void* p,
                           const void* g, void* dp, int B, int H, int W,
                           int border, int squared, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* v) { return static_cast<const float*>(v); };
  auto o = static_cast<float*>(dp);
  return squared ? launch<true, true>(B, H, W, border, s, f(hr), f(m), f(p),
                                     f(g), o)
                 : launch<true, false>(B, H, W, border, s, f(hr), f(m), f(p),
                                       f(g), o);
}

// The plan of a call on this card: out[0..6] = blocks a cluster, crop rows
// a band, crop rows and columns a tile, warps a block, parts of the items,
// dynamic shared memory bytes a block, and out[7] the clusters of the
// forward L1 kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters); REFUSED (-1) where the kernels refuse
// the planes.
int probav_shift_table_plan(int B, int H, int W, int border, int* out) {
  Plan q;
  const int code = plan_for<false, false>(B, H, W, border, q);
  if (code != 0) return code;
  Launch l(q, B, nullptr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, shift_table_kernel<false, false>, &l.cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();   // the query's own error, left pending by it
    return err;
  }
  const int v[8] = {q.nb, q.R, q.RT, q.CT, q.NW, q.P, q.smem, clusters};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
  return 0;
}

}  // extern "C"
