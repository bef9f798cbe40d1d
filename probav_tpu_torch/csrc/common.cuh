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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
