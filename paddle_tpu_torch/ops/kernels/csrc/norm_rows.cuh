// norm_rows.cuh: the row body of the RMS norm kernels for Hopper (sm_90a),
// shared by rms_norm.cu (o = rms_norm(x) * w) and add_rms_norm.cu (y = x + r
// rounded to x's type, then o = rms_norm(y) * w).
//
// Per row: o = y * rsqrt(mean(y^2) + eps) * w, with y = x (no residual) or
// the rounded x + r; the weight applied in f32 and the result rounded once
// to x's type, plus the f32 rstd. x, r and w are each f32 or bf16, in any
// mix, or x f16 with r and w each f16 or f32; y and o take x's type.
//
// Bound: each row is read once and written once (x, and r, in; y and o
// out) with a few operations per element, so the bytes over the card's
// memory rate bound it.
//
// Design:
// - A row is held in registers by `tpr` threads (32 to 256, at most 32
//   values a thread), so it crosses device memory once. A block of 256
//   threads holds 256 / tpr rows at a time.
// - Each thread loads 16-byte vectors: chunk j of thread t starts at column
//   (j * tpr + t) * E, with E = 8 bf16 or f16 or 4 f32 values of x, so neighbouring
//   threads read neighbouring 16 bytes; the weight and the residual at the
//   same columns come in 16- or 8-byte loads. A row whose width is not a
//   multiple of E, or a pointer that is not 16-byte aligned, takes the same
//   layout with scalar loads; columns past H read as zero and are not
//   written.
// - The grid holds as many blocks as fit on the card at once; each block
//   walks rows with a stride, so it reads the weight once (into registers,
//   after its first row's loads are issued) whatever the number of rows,
//   and loads its next row while it reduces and writes the current one
//   (while the row takes at most 4 chunks a thread).
// - The sum of squares is reduced by shuffles within a warp and, for rows
//   wider than a warp, through shared memory (double-buffered by the
//   block's row step, one __syncthreads a step).
// - The mean is the sum times 1 / H: an f32 division is a called
//   subroutine, which ptxas counts as a spill.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace norm_rows {

constexpr int kThreads = 256;
constexpr int kMaxH = 8192;

// One value of T: f32, bf16 or f16. kVec values of x fill a 16-byte chunk.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // 8 values rounded to nearest even, low half first
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(w[i])
          : "f"(v[2 * i + 1]), "f"(v[2 * i]));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Elem<__half> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ void put(__half* p, float v) {
    *p = __float2half_rn(v);
  }
  // 8 values rounded to nearest even, low half first
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm("cvt.rn.f16x2.f32 %0, %1, %2;\n"
          : "=r"(w[i])
          : "f"(v[2 * i + 1]), "f"(v[2 * i]));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The bits of a bf16 or f16 value.
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits16(__half v) {
  return __half_as_ushort(v);
}

// E values of T (a chunk of x, of the residual or of the weight, at x's
// columns) are kept as they were loaded, E * sizeof(T) bytes in 32-bit
// words, and widened to f32 where they are used: a prefetched chunk of x
// costs 4 registers.
template <typename T, int E>
struct Vals {
  static constexpr int kWords = E * (int)sizeof(T) / 4;
  using Raw = uint32_t[kWords];
  // at p, 16-byte aligned: 16-byte loads, or one 8-byte load for 4 bf16
  static __device__ __forceinline__ void load(Raw& w, const T* p) {
    if constexpr (kWords == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z,
                  w[4 * i + 3] = u.w;
      }
    }
  }
  // the first min(n, E) values at p (n >= 1); the rest read as zero
  static __device__ __forceinline__ void gather(Raw& w, const T* p, int n) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < E; ++e) w[e] = e < n ? __float_as_uint(p[e]) : 0u;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const uint32_t lo = 2 * i < n ? bits16(p[2 * i]) : 0u;
        const uint32_t hi = 2 * i + 1 < n ? bits16(p[2 * i + 1]) : 0u;
        w[i] = lo | hi << 16;
      }
    }
  }
  static __device__ __forceinline__ void widen(const Raw& w, float* v) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (sizeof(T) == 4)
        v[e] = __uint_as_float(w[e]);
      else if constexpr (std::is_same_v<T, __half>)
        v[e] = __half2float(__ushort_as_half(
            (unsigned short)(e % 2 ? w[e / 2] >> 16 : w[e / 2] & 0xffffu)));
      else
        v[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u
                                     : w[e / 2] << 16);
    }
  }
};

// Chunk j of this thread's columns of row `row` of a [N, H] tensor of T
// (zero past H or for a row past N), E values a chunk: vector loads, or
// scalar loads where the row is not 16-byte aligned.
template <typename T, int E, int V>
__device__ __forceinline__ void load_row(
    typename Vals<T, E>::Raw (&raw)[V], const T* t, long long row, bool live,
    int h, int tpr, int tx, int vec) {
  const T* tr = t + row * h;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c0 = (j * tpr + tx) * E;
    if (!live || c0 >= h) {
#pragma unroll
      for (int i = 0; i < Vals<T, E>::kWords; ++i) raw[j][i] = 0u;
    } else if (vec) {
      Vals<T, E>::load(raw[j], tr + c0);
    } else {
      Vals<T, E>::gather(raw[j], tr + c0, h - c0);
    }
  }
}

// The rows of one block; Tr = void: no residual (x is y, and y is not
// written). V chunks of E values a thread; blockDim = (tpr, 256 / tpr).
template <typename Tx, typename Tr, typename Tw, int V>
__device__ __forceinline__ void norm(const Tx* __restrict__ x,
                                     const Tr* __restrict__ r,
                                     const Tw* __restrict__ w,
                                     Tx* __restrict__ y, Tx* __restrict__ o,
                                     float* __restrict__ rstd, int n, int h,
                                     float inv_h, float eps, int vec) {
  constexpr int E = Elem<Tx>::kVec;
  constexpr bool kRes = !std::is_void_v<Tr>;
  using XV = Vals<Tx, E>;
  using RV = Vals<std::conditional_t<kRes, Tr, float>, E>;
  // the next row is loaded ahead while up to 4 chunks a thread are held;
  // at 8 (f32 rows wider than 4096) the two rows would cost the block its
  // registers, and the next row is loaded after the current one is written
  constexpr bool kAhead = V <= 4;
  __shared__ float part[2][kThreads / 32][kThreads / 32];
  const int tpr = blockDim.x, rpb = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lane = tx & 31, warp = tx >> 5, nwarps = tpr >> 5;
  const long long stride = (long long)gridDim.x * rpb;

  // the block's first row, then the weight at this thread's columns (read
  // once, its latency under the row's)
  long long base = (long long)blockIdx.x * rpb;
  typename XV::Raw cur[V], nxt[V];
  typename RV::Raw rcur[V], rnxt[V];
  load_row<Tx, E, V>(cur, x, base + ty, base + ty < n, h, tpr, tx, vec);
  if constexpr (kRes)
    load_row<Tr, E, V>(rcur, r, base + ty, base + ty < n, h, tpr, tx, vec);
  float wr[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c0 = (j * tpr + tx) * E;
    if (vec && c0 < h) {
      typename Vals<Tw, E>::Raw raw;
      Vals<Tw, E>::load(raw, w + c0);
      Vals<Tw, E>::widen(raw, wr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        wr[j][e] = c0 + e < h ? Elem<Tw>::get(w[c0 + e]) : 0.f;
    }
  }

  for (int step = 0; base < n; base += stride, ++step) {
    const long long row = base + ty;
    const bool live = row < n;
    // the block's next row is in flight while this one is added, reduced
    // and written
    const long long nbase = base + stride;
    if (kAhead && nbase < n) {
      load_row<Tx, E, V>(nxt, x, nbase + ty, nbase + ty < n, h, tpr, tx,
                         vec);
      if constexpr (kRes)
        load_row<Tr, E, V>(rnxt, r, nbase + ty, nbase + ty < n, h, tpr, tx,
                           vec);
    }
    if constexpr (kRes) {
      // y = x + r in f32, rounded to x's type: the norm reads the rounded y
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float xv[E], rv[E];
        XV::widen(cur[j], xv);
        RV::widen(rcur[j], rv);
#pragma unroll
        for (int e = 0; e < E; ++e) xv[e] += rv[e];
        const uint4 y4 = Elem<Tx>::pack(xv);
        cur[j][0] = y4.x, cur[j][1] = y4.y, cur[j][2] = y4.z, cur[j][3] = y4.w;
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xv[E];
      XV::widen(cur[j], xv);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(xv[e], xv[e], ss);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
    if (nwarps > 1) {  // uniform over the block: tpr is
      float* p = part[step & 1][ty];
      if (lane == 0) p[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int i = 0; i < nwarps; ++i) ss += p[i];
    }
    // the mean as torch takes it: the sum times 1 / h
    const float rs = rsqrtf(ss * inv_h + eps);
    if (live) {
      if (tx == 0) rstd[row] = rs;
      Tx* orow = o + row * h;
      Tx* yrow = kRes ? y + row * h : nullptr;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c0 = (j * tpr + tx) * E;
        float ov[E];
        XV::widen(cur[j], ov);
        if constexpr (kRes) {
          if (vec) {
            if (c0 < h)
              *reinterpret_cast<uint4*>(yrow + c0) =
                  make_uint4(cur[j][0], cur[j][1], cur[j][2], cur[j][3]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e)
              if (c0 + e < h) Elem<Tx>::put(yrow + c0 + e, ov[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) ov[e] = ov[e] * rs * wr[j][e];
        if (vec) {
          if (c0 < h)
            *reinterpret_cast<uint4*>(orow + c0) = Elem<Tx>::pack(ov);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (c0 + e < h) Elem<Tx>::put(orow + c0 + e, ov[e]);
        }
      }
    }
    if (kAhead) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int i = 0; i < XV::kWords; ++i) cur[j][i] = nxt[j][i];
        if constexpr (kRes)
#pragma unroll
          for (int i = 0; i < RV::kWords; ++i) rcur[j][i] = rnxt[j][i];
      }
    } else if (nbase < n) {
      load_row<Tx, E, V>(cur, x, nbase + ty, nbase + ty < n, h, tpr, tx,
                         vec);
      if constexpr (kRes)
        load_row<Tr, E, V>(rcur, r, nbase + ty, nbase + ty < n, h, tpr, tx,
                           vec);
    }
  }
}

// Launches kernel(args...) over n rows with as many blocks of tpr x
// (256 / tpr) threads as fit on the card at once (`resident`, found at the
// kernel's first launch), or fewer where the rows need fewer.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int& resident, int n, int tpr,
                   cudaStream_t stream, Args... args) {
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = (per_sm < 1 ? 1 : per_sm) * sms;
  }
  const int rpb = kThreads / tpr;
  const long long need = ((long long)n + rpb - 1) / rpb;
  const int grid = (int)(need < resident ? need : resident);
  kernel<<<grid, dim3(tpr, rpb), 0, stream>>>(args...);
  return cudaGetLastError();
}

// The fewest threads a row (tpr) that keep each at most 32 values, and
// f(std::integral_constant<int, V>) with V >= the chunks of E values each
// thread then holds (1, 2, 4, or 8 for f32 x). cudaErrorInvalidValue for
// h outside 1..kMaxH.
template <int E, typename F>
cudaError_t by_chunks(int h, F&& f) {
  if (h < 1 || h > kMaxH) return cudaErrorInvalidValue;
  int tpr = 32;
  while (tpr * 32 < h) tpr *= 2;
  const int chunks = (h + tpr * E - 1) / (tpr * E);
  if (chunks == 1) return f(tpr, std::integral_constant<int, 1>{});
  if (chunks == 2) return f(tpr, std::integral_constant<int, 2>{});
  if (chunks <= 4) return f(tpr, std::integral_constant<int, 4>{});
  if constexpr (E == 4)  // f32 only: 8 chunks of 4
    return f(tpr, std::integral_constant<int, 8>{});
  return cudaErrorInvalidValue;
}

// 1 where every pointer is 16-byte aligned and h a multiple of E (the
// vector loads), else 0 (scalar loads)
template <int E, typename... P>
int vectorizable(int h, P... ptrs) {
  return h % E == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) | ...) % 16) == 0;
}

}  // namespace norm_rows
