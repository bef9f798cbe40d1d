// Helpers shared by the kernel sources of probav_tpu_torch/csrc.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace probav {

// bf16 on the tensor cores: mma.sync.m16n8k16, float32 accumulators.
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): with
// g = lane / 4 and q = lane % 4, A (16x16, row-major) holds rows g and g+8,
// columns 2q, 2q+1 and 2q+8, 2q+9; B (16x8, column-major) holds rows 2q,
// 2q+1 and 2q+8, 2q+9 of column g; C (16x8) holds rows g and g+8, columns
// 2q, 2q+1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// TF32 on the tensor cores: mma.sync.m16n8k8, float32 accumulators.  Each
// 32-bit register holds one TF32 value (a float32 whose low 13 mantissa
// bits are zero): A (16x8, row-major) holds rows g and g+8 at columns q and
// q+4 (a0 = (g, q), a1 = (g+8, q), a2 = (g, q+4), a3 = (g+8, q+4)); B (8x8,
// column-major) rows q and q+4 of column g; C as for m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32 on the tensor cores as 3xTF32: v splits into hi = v rounded to
// TF32 (to nearest, ties away from zero: cvt.rna's rounding, two integer
// operations, without its four-instruction Inf/NaN guard) and lo = v - hi
// (exact in float32, |lo| <= 2^-11 |v|), and a product into acc += lo_a
// hi_b + hi_a lo_b + hi_a hi_b, lo_a lo_b dropped: about 2^-20 of relative
// error per product at most.  lo goes to the tensor cores as it is: they
// read a TF32 operand's top 19 bits, so lo loses at most 2^-10 of itself,
// 2^-21 of v.  A value on a grid that TF32 holds (11 significant bits)
// splits exactly, with lo = 0.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// The four words v of a fragment, split.
__device__ __forceinline__ void split_tf32(const uint32_t (&v)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(v[j]), hi[j], lo[j]);
}

// One A (16x8) or B (8x8) fragment of mma_tf32, split into its TF32
// halves.
struct FragA { uint32_t h[4], l[4]; };
struct FragB { uint32_t h[2], l[2]; };

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  split_tf32(a0, f.h[0], f.l[0]);
  split_tf32(a1, f.h[1], f.l[1]);
  split_tf32(a2, f.h[2], f.l[2]);
  split_tf32(a3, f.h[3], f.l[3]);
}

__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split_tf32(b0, f.h[0], f.l[0]);
  split_tf32(b1, f.h[1], f.l[1]);
}

// Term `term` of the 3xTF32 product: 0 hi hi, 1 lo hi, 2 hi lo.  Callers
// sweep each term over several accumulators, so that no mma waits on the
// one before.
__device__ __forceinline__ void mma_term(float (&c)[4], const FragA& a,
                                         const FragB& b, int term) {
  if (term == 0) mma_tf32(c, a.h, b.h[0], b.h[1]);
  else if (term == 1) mma_tf32(c, a.l, b.h[0], b.h[1]);
  else mma_tf32(c, a.h, b.l[0], b.l[1]);
}

// Asynchronous copies from device memory into shared memory (cp.async).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

// 16 (or 4) bytes from src where `valid`, else zeros (nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [0, ROWS) of a [*, cols] float tile at src into dst
// (row stride STRIDE floats): zeros for rows from nrows on; columns from
// cols to STRIDE are not written.  16-byte copies where `vec` (cols a
// multiple of 4, src 16-byte aligned), else 4-byte ones.
template <int ROWS, int STRIDE>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int nrows, int cols, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < ROWS * c4; e += blockDim.x) {
      const int r = e / c4, c = 4 * (e % c4);
      const bool in = r < nrows;
      cp_async16_zfill(dst + r * STRIDE + c, in ? src + r * cols + c : src,
                       in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * cols; e += blockDim.x) {
      const int r = e / cols, c = e % cols;
      const bool in = r < nrows;
      cp_async4_zfill(dst + r * STRIDE + c, in ? src + e : src, in);
    }
  }
}

// Bytes of a raw buffer for a span of n bytes copied from the 16-byte chunk
// below its start (and for a run of out staged at its 16-byte skew).
inline size_t run_buf_bytes(size_t n) {
  return (n + 43) / 16 * 16;
}

// Start the copy of src[0, n) into buf by 16-byte cp.async, from the chunk
// below src on (every chunk read holds an element of the span); returns the
// element offset of src[0] in buf.
template <typename E>
__device__ __forceinline__ int copy_async(E* buf, const E* src, int n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = s & ~uintptr_t(15);
  const int chunks = (int)((s + sizeof(E) * (uintptr_t)n + 15 - a) / 16);
  char* dst = reinterpret_cast<char*>(buf);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    cp_async16(dst + 16 * i, a + 16 * (uintptr_t)i);
  return (int)((s - a) / sizeof(E));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  Plain: register j of lane l holds row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of matrix j.  .trans: the transpose,
// rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// dst[j] = buf[skew + j] for j < cnt, by the lanes of one warp: skew is
// dst's element offset in its 16-byte chunk, so buf's chunks line up with
// dst's; whole chunks go as 16-byte stores, the span's two ends element by
// element.
__device__ __forceinline__ void store_span_warp(__nv_bfloat16* dst,
                                                const __nv_bfloat16* buf,
                                                int skew, int cnt,
                                                int lane) {
  const int chunks = (skew + cnt + 7) / 8;
  for (int i = lane; i < chunks; i += 32) {
    const int j0 = 8 * i - skew;   // span index of the chunk's first element
    if (j0 >= 0 && j0 + 8 <= cnt) {
      *reinterpret_cast<uint4*>(dst + j0) =
          *reinterpret_cast<const uint4*>(buf + 8 * i);
    } else {
      for (int k = 0; k < 8; ++k)
        if (j0 + k >= 0 && j0 + k < cnt) dst[j0 + k] = buf[8 * i + k];
    }
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 of (max(lo, 0), max(hi, 0)), each rounded to nearest even.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Element <-> float32, and rounding a float32 to the element type.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// The widest channel count any kernel of the block stack takes (C, C_dec;
// ops/tstack.t_tier_refusal states the same).
constexpr int MAX_CH = 128;

// f(std::integral_constant<int, B>()) for B, the 32-channel bucket of c:
// the compile-time register or tile width of c channels, 1 <= c <= MAX_CH.
template <typename F>
__host__ auto by_bucket(int c, F&& f) {
  if (c <= 32) return f(std::integral_constant<int, 32>());
  if (c <= 64) return f(std::integral_constant<int, 64>());
  if (c <= 96) return f(std::integral_constant<int, 96>());
  return f(std::integral_constant<int, 128>());
}

inline int optin_smem() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 232448;
  return optin;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

// The 3^3 SAME conv of tstack.cu, shared with the block backward:
// out = conv(d, wc) (+ bc + x when `residual`).  d [B,H,W,T,c_dec],
// wc [3,3,3,c_dec,c_out], out [B,H,W,T,c_out]; dtype 0 float32, 1 bf16.
// cudaErrorInvalidValue, before any launch, outside its envelope
// (tstack.cu, conv_ring_kernel).
cudaError_t conv_dispatch(int dtype, bool residual, const void* d,
                          const void* x, const void* wc, const void* bc,
                          void* out, int B, int H, int W, int Tn, int c_dec,
                          int c_out, cudaStream_t s);

}  // namespace probav
