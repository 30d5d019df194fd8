// RMS norm forward for Hopper (sm_90a): a row kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` behind `rms_norm`
// (paddle_tpu/ops/pallas/rms_norm.py:25, pallas_call in `_fwd_call` at :43):
// per row o = x * rsqrt(mean(x^2) + eps) * w, the weight applied in f32 and
// the result rounded once to x's type, plus the f32 rstd. x and w are each
// f32 or bf16, in any mix; o takes x's type.
//
// Bound: each row is read once and written once with a few operations per
// element, so the bytes over the card's memory rate bound it.
//
// Design:
// - A row is held in registers by `tpr` threads (32 to 256, at most 32
//   values a thread), so x crosses device memory once. A block of 256
//   threads holds 256 / tpr rows at a time.
// - Each thread loads 16-byte vectors: chunk j of thread t starts at column
//   (j * tpr + t) * E, with E = 8 bf16 or 4 f32 values, so neighbouring
//   threads read neighbouring 16 bytes; the weight at the same columns
//   comes in 16- or 8-byte loads. A row whose width is not a multiple of
//   E, or a pointer that is not 16-byte aligned, takes the same layout
//   with scalar loads; columns past H read as zero and are not written.
// - The grid holds as many blocks as fit on the card at once; each block
//   walks rows with a stride, so it reads the weight once (into registers,
//   after its first row's loads are issued) whatever the number of rows,
//   and loads its next row while it reduces and writes the current one
//   (while the row takes at most 4 chunks a thread).
// - The sum of squares is reduced by shuffles within a warp and, for rows
//   wider than a warp, through shared memory (double-buffered by the
//   block's row step, one __syncthreads a step).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

// A chunk of 16 bytes is kept as it was loaded (four 32-bit words) and
// widened to f32 where it is used, so a prefetched row costs 4 registers a
// chunk.
template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // values in 16 bytes
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ void widen(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
  // the first min(n, 4) values at p (n >= 1); the rest read as zero
  static __device__ __forceinline__ uint4 gather(const float* p, int n) {
    return make_uint4(__float_as_uint(p[0]),
                      n > 1 ? __float_as_uint(p[1]) : 0u,
                      n > 2 ? __float_as_uint(p[2]) : 0u,
                      n > 3 ? __float_as_uint(p[3]) : 0u);
  }
  static __device__ __forceinline__ void put(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ void widen(const uint4& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // the first min(n, 8) values at p; the rest read as zero
  static __device__ __forceinline__ uint4 gather(const __nv_bfloat16* p,
                                                 int n) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? __bfloat16_as_ushort(p[2 * i]) : 0u;
      const uint32_t hi =
          2 * i + 1 < n ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
      w[i] = lo | hi << 16;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // round to nearest even, low half first
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(w[i])
          : "f"(v[2 * i + 1]), "f"(v[2 * i]));
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Chunk j of this thread's row `row` (zero past H or for a row past N):
// one 16-byte load, or E scalar loads where the row is not 16-byte aligned.
template <typename Tx, int V>
__device__ __forceinline__ void load_row(uint4 (&raw)[V], const Tx* x,
                                         long long row, bool live, int h,
                                         int tpr, int tx, int vec) {
  constexpr int E = Elem<Tx>::kVec;
  const Tx* xr = x + row * h;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c0 = (j * tpr + tx) * E;
    if (!live || c0 >= h)
      raw[j] = make_uint4(0, 0, 0, 0);
    else if (vec)
      raw[j] = *reinterpret_cast<const uint4*>(xr + c0);
    else
      raw[j] = Elem<Tx>::gather(xr + c0, h - c0);
  }
}

// E weight values at p, 16-byte aligned, widened to f32: one or two
// 16-byte loads, or one 8-byte load for 4 bf16 values.
template <typename Tw, int E>
__device__ __forceinline__ void load_weight(const Tw* p, float (&v)[E]) {
  if constexpr (sizeof(Tw) == 4) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i)
      Elem<float>::widen(reinterpret_cast<const uint4*>(p)[i], v + 4 * i);
  } else if constexpr (E == 8) {
    Elem<__nv_bfloat16>::widen(*reinterpret_cast<const uint4*>(p), v);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t b = i ? u.y : u.x;
      v[2 * i] = __uint_as_float(b << 16);
      v[2 * i + 1] = __uint_as_float(b & 0xffff0000u);
    }
  }
}

// V chunks of E values a thread; blockDim = (tpr, 256 / tpr).
template <typename Tx, typename Tw, int V>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                    Tx* __restrict__ o, float* __restrict__ rstd, int n,
                    int h, float inv_h, float eps, int vec) {
  constexpr int E = Elem<Tx>::kVec;
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
  uint4 cur[V], nxt[V];
  load_row<Tx, V>(cur, x, base + ty, base + ty < n, h, tpr, tx, vec);
  float wr[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c0 = (j * tpr + tx) * E;
    if (vec && c0 < h) {
      load_weight<Tw, E>(w + c0, wr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        wr[j][e] = c0 + e < h ? Elem<Tw>::get(w[c0 + e]) : 0.f;
    }
  }

  for (int step = 0; base < n; base += stride, ++step) {
    const long long row = base + ty;
    const bool live = row < n;
    // the block's next row is in flight while this one is reduced and
    // written
    const long long nbase = base + stride;
    if (kAhead && nbase < n)
      load_row<Tx, V>(nxt, x, nbase + ty, nbase + ty < n, h, tpr, tx, vec);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float xv[E];
      Elem<Tx>::widen(cur[j], xv);
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
    // the mean as torch takes it: the sum times 1 / h (no division, whose
    // slow path is a called subroutine)
    const float r = rsqrtf(ss * inv_h + eps);
    if (live) {
      if (tx == 0) rstd[row] = r;
      Tx* orow = o + row * h;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c0 = (j * tpr + tx) * E;
        float ov[E];
        Elem<Tx>::widen(cur[j], ov);
#pragma unroll
        for (int e = 0; e < E; ++e) ov[e] = ov[e] * r * wr[j][e];
        if (vec) {
          if (c0 < h) Elem<Tx>::store(orow + c0, ov);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (c0 + e < h) Elem<Tx>::put(orow + c0 + e, ov[e]);
        }
      }
    }
    if (kAhead) {
#pragma unroll
      for (int j = 0; j < V; ++j) cur[j] = nxt[j];
    } else if (nbase < n) {
      load_row<Tx, V>(cur, x, nbase + ty, nbase + ty < n, h, tpr, tx, vec);
    }
  }
}

template <typename Tx, typename Tw, int V>
cudaError_t launch(const void* x, const void* w, void* o, void* rstd, int n,
                   int h, float eps, int tpr, int vec, cudaStream_t stream) {
  static int blocks_per_sm = 0, sms = 0;  // per instantiation, once
  if (blocks_per_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, rms_norm_kernel<Tx, Tw, V>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  const int rpb = kThreads / tpr;
  const long long need = ((long long)n + rpb - 1) / rpb;
  const int grid = (int)(need < (long long)blocks_per_sm * sms
                             ? need
                             : (long long)blocks_per_sm * sms);
  rms_norm_kernel<Tx, Tw, V><<<grid, dim3(tpr, rpb), 0, stream>>>(
      (const Tx*)x, (const Tw*)w, (Tx*)o, (float*)rstd, n, h, 1.f / (float)h,
      eps, vec);
  return cudaGetLastError();
}

template <typename Tx, typename Tw>
cudaError_t dispatch(const void* x, const void* w, void* o, void* rstd,
                     int n, int h, float eps, cudaStream_t stream) {
  constexpr int E = Elem<Tx>::kVec;
  // the fewest threads a row that keep each at most 32 values
  int tpr = 32;
  while (tpr * 32 < h) tpr *= 2;
  const int chunks = (h + tpr * E - 1) / (tpr * E);
  const int vec = h % E == 0 && (reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(w) |
                                 reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  if (chunks == 1)
    return launch<Tx, Tw, 1>(x, w, o, rstd, n, h, eps, tpr, vec, stream);
  if (chunks == 2)
    return launch<Tx, Tw, 2>(x, w, o, rstd, n, h, eps, tpr, vec, stream);
  if (chunks <= 4)
    return launch<Tx, Tw, 4>(x, w, o, rstd, n, h, eps, tpr, vec, stream);
  if constexpr (E == 4)  // f32 only: 8 chunks of 4
    return launch<Tx, Tw, 8>(x, w, o, rstd, n, h, eps, tpr, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x/o [n, h] row-major, w [h], rstd [n] f32; x_dtype and w_dtype: 0 =
// float32, 1 = bfloat16. 1 <= h <= 8192. Returns the CUDA error of the
// launch (0 on success, and for n = 0; cudaErrorInvalidValue for what it
// does not take).
extern "C" int rms_norm_launch(const void* x, const void* w, void* o,
                               void* rstd, int n, int h, float eps,
                               int x_dtype, int w_dtype, void* stream) {
  if (n < 0 || h < 1 || h > 8192 || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)(w_dtype == 0
                     ? dispatch<float, float>(x, w, o, rstd, n, h, eps, s)
                     : dispatch<float, __nv_bfloat16>(x, w, o, rstd, n, h,
                                                      eps, s));
  return (int)(w_dtype == 0
                   ? dispatch<__nv_bfloat16, float>(x, w, o, rstd, n, h, eps,
                                                    s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, o, rstd, n,
                                                            h, eps, s));
}
