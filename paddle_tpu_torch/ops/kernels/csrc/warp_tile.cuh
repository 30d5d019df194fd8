// Warp-level tile helpers shared by the training kernels (flash attention
// forward and backward, swiglu_down), for Hopper (sm_90a).
//
// The one primitive is warp_mma: a warp multiplies a 16-row tile of A by
// the transpose of an (8*NT)-row tile of B, both read from shared memory
// through explicit strides, into m16n8 accumulator fragments held in
// registers. bf16 operands run mma.sync m16n8k16 with f32 accumulation;
// f32 operands run the same fragments with plain FMAs (the f32 variant
// exists for the checks, not for speed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptk {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += a . b for one m16n8k16 tile (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] += A(16 x K) . B(8*NT x K)^T over k < K, where
//   A(r, k) = A[r*ar + k*ak]   (r < 16: the warp's rows),
//   B(n, k) = B[n*bn + k*bk]   (n < 8*NT),
// and acc[j] is the accumulator fragment of n-tile j: lane (g = lane/4,
// t = lane%4) holds {(g, 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t), (g+8, 8j+2t+1)}.
// For bf16, K is a multiple of 16 (mma.sync fragment layout of the PTX
// ISA: a0..a3 = rows g/g+8 x cols 2t/2t+8, b0..b1 = rows 2t/2t+8 x col g).
template <typename T, int NT>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const T* A, int ar,
                                         int ak, const T* B, int bn, int bk,
                                         int K, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * ar + k * ak], a1 = A[(g + 8) * ar + k * ak];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = B[(8 * j + 2 * t) * bn + k * bk];
        const float b1 = B[(8 * j + 2 * t + 1) * bn + k * bk];
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * t;
      uint32_t a[4];
      a[0] = pack_bf16(A[g * ar + ka * ak], A[g * ar + (ka + 1) * ak]);
      a[1] = pack_bf16(A[(g + 8) * ar + ka * ak],
                       A[(g + 8) * ar + (ka + 1) * ak]);
      a[2] = pack_bf16(A[g * ar + (ka + 8) * ak], A[g * ar + (ka + 9) * ak]);
      a[3] = pack_bf16(A[(g + 8) * ar + (ka + 8) * ak],
                       A[(g + 8) * ar + (ka + 9) * ak]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        uint32_t b[2];
        b[0] = pack_bf16(B[n * bn + ka * bk], B[n * bn + (ka + 1) * bk]);
        b[1] = pack_bf16(B[n * bn + (ka + 8) * bk], B[n * bn + (ka + 9) * bk]);
        mma_16816(acc[j], a, b);
      }
    }
  }
}

// Copy rows [0, rows) of a [*, D] row-major global tile into shared memory
// with row stride ld, 16 bytes per thread and step; rows >= valid are
// zero. Both pointers and D * sizeof(T) are multiples of 16 bytes.
template <typename T, int D, int THREADS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int rows, int valid, int tid) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = tid; i < rows * kPerRow; i += THREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

}  // namespace ptk
