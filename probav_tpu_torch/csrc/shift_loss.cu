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
// One block per sample stages its three H x W planes in shared memory once
// (27.6 KB at 48 x 48), as _fwd_kernel stages a batch tile in VMEM; the
// TPU's 8-sample batch tile (TILE_B, a sublane rule) is not ported.  In the
// forward and in the backward's first pass each warp takes one shift at a
// time: its lanes stride over the window's pixels, and warp shuffles
// reduce the sums, in a fixed order.  The backward's second pass gives
// each thread whole output pixels, summing the 49 shifts' terms in shift
// order, so no atomics are used and a run is deterministic.
//
// What bounds it on an H100: at B = 128, 48 x 48, border 3 the inputs are
// 3.5 MB (1.1 us at 3.35 TB/s) and the forward does ~9 FLOP per pixel and
// shift over 49 x 42 x 42 windows, 0.1 GFLOP (1.5 us at the 67 TFLOP/s
// float32 peak); the backward about twice that.  A launch costs more than
// either: this first version keeps the work on chip and leaves the launch
// overhead as it is.

#include "common.cuh"

namespace {

constexpr int ST_WARPS = 8;
constexpr int ST_THREADS = ST_WARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane adds the same pairs, so all lanes agree exactly.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.f) - (v < 0.f));
}

// Stage sample blockIdx.x's hr, m, p planes into smem [3][H*W].
__device__ __forceinline__ void stage(const float* __restrict__ hr,
                                      const float* __restrict__ m,
                                      const float* __restrict__ p,
                                      float* smem, int hw) {
  const long off = (long)blockIdx.x * hw;
  for (int e = threadIdx.x; e < hw; e += blockDim.x) {
    smem[e] = hr[off + e];
    smem[hw + e] = m[off + e];
    smem[2 * hw + e] = p[off + e];
  }
}

// (total, bias) of shift (i, j), held by every lane of the calling warp.
__device__ __forceinline__ void shift_bias(const float* shr, const float* sm,
                                           const float* sp, int W, int border,
                                           int ch, int cw, int i, int j,
                                           float& total, float& bias) {
  float a = 0.f, h = 0.f, pm = 0.f;
  for (int q = threadIdx.x % 32; q < ch * cw; q += 32) {
    const int y = q / cw, x = q % cw;
    const int t = (i + y) * W + j + x;
    const float mv = sm[t];
    a += mv;
    h += shr[t];
    pm += sp[(border + y) * W + border + x] * mv;
  }
  total = warp_sum(a);
  bias = (warp_sum(h) - warp_sum(pm)) / total;
}

__global__ void __launch_bounds__(ST_THREADS)
shift_table_fwd_kernel(const float* __restrict__ hr,
                       const float* __restrict__ m,
                       const float* __restrict__ p, float* __restrict__ out,
                       int H, int W, int border, int squared) {
  extern __shared__ __align__(16) float smem[];
  const int hw = H * W;
  const float *shr = smem, *sm = smem + hw, *sp = smem + 2 * hw;
  stage(hr, m, p, smem, hw);
  __syncthreads();
  const int n_sh = 2 * border + 1, S = n_sh * n_sh;
  const int ch = H - 2 * border, cw = W - 2 * border;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int s = warp; s < S; s += ST_WARPS) {
    const int i = s / n_sh, j = s % n_sh;
    float total, bias;
    shift_bias(shr, sm, sp, W, border, ch, cw, i, j, total, bias);
    float acc = 0.f;
    for (int q = lane; q < ch * cw; q += 32) {
      const int y = q / cw, x = q % cw;
      const int t = (i + y) * W + j + x;
      const float r =
          shr[t] - (sp[(border + y) * W + border + x] + bias) * sm[t];
      acc += squared ? r * r : fabsf(r);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[(long)blockIdx.x * S + s] = acc / total;
  }
}

__global__ void __launch_bounds__(ST_THREADS)
shift_table_bwd_kernel(const float* __restrict__ hr,
                       const float* __restrict__ m,
                       const float* __restrict__ p,
                       const float* __restrict__ g, float* __restrict__ dp,
                       int H, int W, int border, int squared) {
  extern __shared__ __align__(16) float smem[];
  const int hw = H * W;
  const int n_sh = 2 * border + 1, S = n_sh * n_sh;
  const float *shr = smem, *sm = smem + hw, *sp = smem + 2 * hw;
  float* st = smem + 3 * hw;     // [S] total
  float* sb = st + S;            // [S] bias
  float* sc = sb + S;            // [S] sum(phi m) / total
  float* sg = sc + S;            // [S] g of this sample
  stage(hr, m, p, smem, hw);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    sg[s] = g[(long)blockIdx.x * S + s];
  __syncthreads();
  const int ch = H - 2 * border, cw = W - 2 * border;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // Pass 1: the per-shift scalars.
  for (int s = warp; s < S; s += ST_WARPS) {
    const int i = s / n_sh, j = s % n_sh;
    float total, bias;
    shift_bias(shr, sm, sp, W, border, ch, cw, i, j, total, bias);
    float acc = 0.f;
    for (int q = lane; q < ch * cw; q += 32) {
      const int y = q / cw, x = q % cw;
      const int t = (i + y) * W + j + x;
      const float mv = sm[t];
      const float r = shr[t] - (sp[(border + y) * W + border + x] + bias) * mv;
      acc += (squared ? 2.f * r : sign_of(r)) * mv;
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      st[s] = total;
      sb[s] = bias;
      sc[s] = acc / total;
    }
  }
  __syncthreads();

  // Pass 2: each thread its output pixels, the shifts summed in order.
  const long off = (long)blockIdx.x * hw;
  for (int q = threadIdx.x; q < hw; q += blockDim.x) {
    const int y = q / W - border, x = q % W - border;
    float acc = 0.f;
    if (y >= 0 && y < ch && x >= 0 && x < cw) {
      const float pv = sp[q];
      for (int s = 0; s < S; ++s) {
        const int i = s / n_sh, j = s % n_sh;
        const int t = (i + y) * W + j + x;
        const float mv = sm[t];
        const float r = shr[t] - (pv + sb[s]) * mv;
        const float phi = squared ? 2.f * r : sign_of(r);
        acc += sg[s] * ((-phi * mv + mv * sc[s]) / st[s]);
      }
    }
    dp[off + q] = acc;
  }
}

template <typename K, typename... Args>
cudaError_t launch(K kern, size_t smem, int B, cudaStream_t s, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<B, ST_THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

bool valid(int B, int H, int W, int border) {
  return B >= 1 && border >= 0 && H > 2 * border && W > 2 * border &&
         (size_t)3 * H * W * sizeof(float) <= 200 * 1024;
}

}  // namespace

extern "C" {

// hr, m, p: float32 [B, H, W]; out: float32 [B, (2 border + 1)^2], the
// shifts row-major over (i, j).  squared: 0 for L1, 1 for L2.
int probav_shift_table_fwd(const void* hr, const void* m, const void* p,
                           void* out, int B, int H, int W, int border,
                           int squared, void* stream) {
  if (!valid(B, H, W, border)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * H * W;
  return (int)launch(shift_table_fwd_kernel, smem, B,
                     static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(hr),
                     static_cast<const float*>(m),
                     static_cast<const float*>(p), static_cast<float*>(out),
                     H, W, border, squared);
}

// As above, with g: float32 [B, S], the cotangent of the table, and dp:
// float32 [B, H, W], the gradient of sum(g * table) with respect to p.
int probav_shift_table_bwd(const void* hr, const void* m, const void* p,
                           const void* g, void* dp, int B, int H, int W,
                           int border, int squared, void* stream) {
  if (!valid(B, H, W, border)) return (int)cudaErrorInvalidValue;
  const int S = (2 * border + 1) * (2 * border + 1);
  const size_t smem = sizeof(float) * (3 * H * W + 4 * S);
  return (int)launch(shift_table_bwd_kernel, smem, B,
                     static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(hr),
                     static_cast<const float*>(m),
                     static_cast<const float*>(p),
                     static_cast<const float*>(g), static_cast<float*>(dp), H,
                     W, border, squared);
}

}  // extern "C"
