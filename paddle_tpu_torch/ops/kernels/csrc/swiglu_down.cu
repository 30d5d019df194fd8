// Fused swiglu + down projection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` behind `swiglu_down`
// (paddle_tpu/ops/pallas/swiglu_down.py:61, pallas_call in `_fwd` at :86):
//
//   out[rows, H] = (silu(gate) * up, rounded to gate's type) @ wd[M, H]
//
// with silu(x) = x * logistic(x) in f32 and f32 accumulation. The
// [rows, M] product never reaches device memory.
//
// Bound: at the training shape ([6144, 5504] x [5504, 2048]) the product
// does about 2 * 6144 * 5504 * 2048 = 139 GFLOP against 2 * 68 MB of gate
// and up and 23 MB of wd, so the bf16 tensor-core rate bounds it.
//
// Design (simple first; no TMA, no wgmma, no pipelining yet):
// - One block of 8 warps per (128-row, 128-column) output tile; the TPU's
//   sequential grid dimension over M becomes a loop inside the block over
//   32-wide k tiles.
// - Each step loads the gate and up tiles (16 bytes per thread and load),
//   forms silu(g) * u in f32, rounds it to the input type into shared
//   memory as the A operand, copies the wd tile to shared memory as B, and
//   each warp runs mma.sync m16n8k16 (bf16 in, f32 accumulate) over its
//   32 x 64 sub-tile. f32 operands run the same fragments with FMAs.
// - Rows may be ragged (masked); M must be a multiple of 32 and H of 128.
#include "warp_tile.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBKm = 32;       // k tile over M
constexpr int kThreads = 256;  // 8 warps as 4 (rows) x 2 (columns)
constexpr int kPad = 8;
constexpr int kLda = kBKm + kPad;
constexpr int kLdb = kBN + kPad;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_down_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                       const T* __restrict__ wd, T* __restrict__ out,
                       int rows, int m, int h) {
  __shared__ __align__(16) T as[kBM * kLda];
  __shared__ __align__(16) T bs[kBKm * kLdb];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  constexpr int kVec = 16 / (int)sizeof(T);

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) ptk::zero<8>(acc[i]);

  for (int k0 = 0; k0 < m; k0 += kBKm) {
    __syncthreads();  // every warp is done with the previous tiles
    constexpr int kPerRowA = kBKm / kVec;
    for (int i = tid; i < kBM * kPerRowA; i += kThreads) {
      const int r = i / kPerRowA, c = (i % kPerRowA) * kVec;
      uint4 gv = make_uint4(0u, 0u, 0u, 0u), uv = gv;
      if (r0 + r < rows) {
        const size_t at = (size_t)(r0 + r) * m + k0 + c;
        gv = *reinterpret_cast<const uint4*>(gate + at);
        uv = *reinterpret_cast<const uint4*>(up + at);
      }
      const T* ge = reinterpret_cast<const T*>(&gv);
      const T* ue = reinterpret_cast<const T*>(&uv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float gf = to_f32(ge[e]);
        const float sig = 1.f / (1.f + expf(-gf));
        as[r * kLda + c + e] = from_f32<T>(gf * sig * to_f32(ue[e]));
      }
    }
    constexpr int kPerRowB = kBN / kVec;
    for (int i = tid; i < kBKm * kPerRowB; i += kThreads) {
      const int r = i / kPerRowB, c = (i % kPerRowB) * kVec;
      *reinterpret_cast<uint4*>(bs + r * kLdb + c) =
          *reinterpret_cast<const uint4*>(wd + (size_t)(k0 + r) * h + c0 +
                                          c);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ptk::warp_mma<T, 8>(acc[i], as + (wr * 32 + i * 16) * kLda, kLda, 1,
                          bs + wc * 64, 1, kLdb, kBKm, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wr * 32 + i * 16 + g + 8 * hh;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        T* dst = out + (size_t)row * h + c0 + wc * 64 + 8 * j + 2 * t;
        dst[0] = from_f32<T>(acc[i][j][2 * hh]);
        dst[1] = from_f32<T>(acc[i][j][2 * hh + 1]);
      }
    }
}

template <typename T>
cudaError_t launch(const void* gate, const void* up, const void* wd,
                   void* out, int rows, int m, int h, cudaStream_t stream) {
  const dim3 grid(h / kBN, (rows + kBM - 1) / kBM);
  swiglu_down_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)gate, (const T*)up, (const T*)wd, (T*)out, rows, m, h);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. gate/up [rows, m], wd [m, h], out
// [rows, h]. Returns the CUDA error of the launch (cudaErrorInvalidValue
// for shapes the kernel does not take: m % 32, h % 128).
extern "C" int swiglu_down_launch(const void* gate, const void* up,
                                  const void* wd, void* out, int rows, int m,
                                  int h, int dtype, void* stream) {
  if (rows < 1 || m < kBKm || m % kBKm || h < kBN || h % kBN ||
      (rows + kBM - 1) / kBM > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(gate, up, wd, out, rows, m, h, s);
  return (int)launch<__nv_bfloat16>(gate, up, wd, out, rows, m, h, s);
}
