// Warp-level tile helpers shared by the f32 routes of the flash forward,
// the fused and split flash backward and swiglu_down (their bf16 routes are
// TMA-fed wgmma kernels on sm90.cuh).
//
// The one primitive is warp_mma: a warp multiplies a 16-row tile of A by
// the transpose of an (8*NT)-row tile of B, both read from shared memory
// through explicit strides, into m16n8 accumulator fragments held in
// registers, with plain f32 FMAs (these routes exist for the checks, not
// for speed).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptk {

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// acc[j] += A(16 x K) . B(8*NT x K)^T over k < K, where
//   A(r, k) = A[r*ar + k*ak]   (r < 16: the warp's rows),
//   B(n, k) = B[n*bn + k*bk]   (n < 8*NT),
// and acc[j] is the accumulator fragment of n-tile j: lane (g = lane/4,
// t = lane%4) holds {(g, 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t), (g+8, 8j+2t+1)}.
template <typename T, int NT>
__device__ __forceinline__ void warp_mma(float (*acc)[4], const T* A, int ar,
                                         int ak, const T* B, int bn, int bk,
                                         int K, int lane) {
  static_assert(std::is_same<T, float>::value, "f32 routes only");
  const int g = lane >> 2, t = lane & 3;
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
