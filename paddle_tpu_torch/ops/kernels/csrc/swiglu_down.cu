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
// and up and 23 MB of wd, about 1,500 FLOP per byte, so the bf16
// tensor-core rate bounds it (0.140 ms at 989 TFLOP/s).
//
// bf16 design: a persistent, warp-specialised wgmma GEMM with the SwiGLU
// prologue fused into its A operand (building blocks in sm90.cuh).
// - One block per SM walks output tiles of 128 rows x 256 columns of H;
//   tiles of one row block are neighbours in the walk, so the gate and up
//   tiles they share come from L2. The k step is 64 over M.
// - Warpgroup 0 is the producer: one thread keeps a 3-stage ring full by
//   TMA (per stage a gate and an up tile of 128 x 64 and a wd tile of
//   64 x 256, 64 KB), completing on one mbarrier per stage. Its
//   registers drop to 40 (setmaxnreg).
// - Warpgroups 1 and 2 are consumers with 232 registers, each owning 64
//   rows. A consumer reads its gate and up values from the swizzled tiles
//   by ldmatrix straight into the A-fragment layout, forms silu(g) * u in
//   f32 (exp2 with log2(e) folded in), rounds it to bf16, and issues
//   wgmma RS m64n128k16 twice per k16 step (256 columns, 128 f32
//   accumulators a thread) with wd as an MN-major B from shared memory.
//   The next stage's prologue runs while the previous stage's wgmmas are in
//   flight (two fragment buffers), and the two consumers interleave, so
//   the SFU work of one overlaps the tensor cores of the other. A consumer
//   releases a stage to the producer once its wgmmas on it are complete.
//   The RS form keeps the product out of shared memory. An SS variant
//   that shared each product between the two CTAs of a cluster (half the
//   sigmoids and gate/up bytes) was correct but several times slower on
//   an H100: its per-k-step cross-CTA handshake set the pace.
// - Epilogue: the accumulators are rounded to bf16, staged in a swizzled
//   shared tile (64 x 128 a consumer, twice) and stored by TMA, which
//   clips ragged rows and columns. TMA's zero fill covers a ragged last k
//   step (silu(0) * 0 = 0) and a last column tile past H.
// f16 operands run the same kernel instantiated with H = true: the
// wgmma form .f32.f16.f16, silu(g) * u rounded by cvt.rn.f16x2.f32 and
// tensor maps of FLOAT16 (sm90.cuh); the sums stay f32 and the output is
// rounded once.
// f32 operands keep the first port's body (mma.sync-shaped fragments run
// as FMAs, no TMA): it exists for the f32 checks, not for speed.
#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;

// ----------------------------------------------- bf16 and f16 route
constexpr int kTM = 128;                       // output rows per tile
constexpr int kTN = 256;                       // output columns per tile
constexpr int kTK = 64;                        // k step over M
constexpr int kStages = 3;
constexpr uint32_t kAB = kTM * kTK * 2;        // a gate or up tile, 16 KB
constexpr uint32_t kWdBox = kTK * 64 * 2;      // wd [64 k][64 n], 8 KB
constexpr uint32_t kStageBytes = 2 * kAB + 4 * kWdBox;  // 64 KB
constexpr uint32_t kOutBox = 64 * 64 * 2;      // output staging box, 8 KB
constexpr uint32_t kOutOff = kStages * kStageBytes;
constexpr uint32_t kBarOff = kOutOff + 4 * kOutBox;
constexpr size_t kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment

// silu(g) * u in f32; exp2 with log2(e) folded in.
__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fdividef(g, 1.f + exp2f(-1.4426950408889634f * g)) * u;
}

// The A fragments of one 64-wide k stage for this warp's 16 rows: rows
// `r0..r0+15` of the swizzled [128][64] gate tile at `g_tile` (up at
// g_tile + kAB), silu(g) * u rounded to bf16 (f16 when H).
template <bool H>
__device__ __forceinline__ void ffn_frags(uint32_t (&fa)[4][4], uint32_t g_tile,
                                          int r0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t row_base = g_tile + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = kk * 2 + (lane >> 4);
    const uint32_t at = row_base + ((chunk ^ (row & 7)) << 4);
    uint32_t g[4], u[4];
    sm90::ldmatrix_x4(g, at);
    sm90::ldmatrix_x4(u, at + kAB);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fa[kk][i] = sm90::pack_x2<H>(
          silu_mul(sm90::lo_x2<H>(g[i]), sm90::lo_x2<H>(u[i])),
          silu_mul(sm90::hi_x2<H>(g[i]), sm90::hi_x2<H>(u[i])));
  }
}

template <bool H>
__global__ void __launch_bounds__(384, 1)
    swiglu_down_wgmma(const __grid_constant__ CUtensorMap g_map,
                      const __grid_constant__ CUtensorMap u_map,
                      const __grid_constant__ CUtensorMap wd_map,
                      const __grid_constant__ CUtensorMap out_map, int rows,
                      int m, int h) {
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t full = base + kBarOff, empty = full + kStages * 8;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = (h + kTN - 1) / kTN;
  const int tiles = (rows + kTM - 1) / kTM * n_tiles;
  const int nk = (m + kTK - 1) / kTK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + 8 * s, 1);
      sm90::mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<40>();
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int r0 = t / n_tiles * kTM, c0 = t % n_tiles * kTN;
        for (int kb = 0; kb < nk; ++kb) {
          sm90::mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t st = base + stage * kStageBytes;
          const uint32_t bar = full + 8 * stage;
          sm90::mbar_arrive_expect_tx(bar, kStageBytes);
          sm90::tma_load_2d(st, &g_map, bar, kb * kTK, r0);
          sm90::tma_load_2d(st + kAB, &u_map, bar, kb * kTK, r0);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sm90::tma_load_2d(st + 2 * kAB + i * kWdBox, &wd_map, bar,
                              c0 + 64 * i, kb * kTK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::reg_alloc<232>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r_frag = 64 * c + 16 * warp;  // this warp's rows in the tile
    float acc0[64], acc1[64];
    uint32_t fa0[4][4], fa1[4][4];
    int stage = 0, prev = -1;
    uint32_t phase = 0;

    // One k stage: wait for it, form its A fragments while the previous
    // stage's wgmmas run, release the previous stage, issue this one's.
    auto step = [&](uint32_t(&fa)[4][4]) {
      sm90::mbar_wait(full + 8 * stage, phase);
      const uint32_t st = base + stage * kStageBytes;
      ffn_frags<H>(fa, st, r_frag, lane);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      sm90::fence_regs(fa0);  // the retired wgmmas' A: live until here
      sm90::fence_regs(fa1);
      if (prev >= 0 && lane == 0) sm90::mbar_arrive(empty + 8 * prev);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b = st + 2 * kAB + kk * 16 * 128;
        sm90::wgmma_rs_n128<1, H>(acc0, fa[kk],
                                  sm90::desc_b128(b, kWdBox, 1024), 1);
        sm90::wgmma_rs_n128<1, H>(
            acc1, fa[kk], sm90::desc_b128(b + 2 * kWdBox, kWdBox, 1024), 1);
      }
      sm90::wgmma_commit();
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    const uint32_t out_buf = base + kOutOff + c * 2 * kOutBox;
    uint8_t* out_ptr = smem + kOutOff + c * 2 * kOutBox;
    // Round 64 rows x 128 columns of accumulators to bf16 (f16 when H),
    // stage them in this consumer's two swizzled boxes and store them by
    // TMA.
    auto store_half = [&](float(&acc)[64], int r0, int col) {
      if (tid == 0) sm90::tma_store_wait_read();  // the boxes are free
      sm90::named_bar_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * warp + g + 8 * hh;
          const int chunk = (j & 7) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(out_ptr + (j >> 3) * kOutBox +
                                       row * 128 + chunk * 16 + 4 * t4) =
              sm90::pack_x2<H>(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      sm90::fence_proxy_async();
      sm90::named_bar_sync(1 + c, 128);
      if (tid == 0) {
        sm90::tma_store_2d(&out_map, out_buf, col, r0 + 64 * c);
        sm90::tma_store_2d(&out_map, out_buf + kOutBox, col + 64, r0 + 64 * c);
        sm90::tma_store_commit();
      }
    };

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = t / n_tiles * kTM, c0 = t % n_tiles * kTN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      int kb = 0;
      for (; kb + 1 < nk; kb += 2) {
        step(fa0);
        step(fa1);
      }
      if (kb < nk) step(fa0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      if (lane == 0) sm90::mbar_arrive(empty + 8 * prev);
      prev = -1;

      // epilogue: 128 columns at a time through two swizzled 64x64 boxes
      store_half(acc0, r0, c0);
      store_half(acc1, r0, c0 + 128);
    }
    if (tid == 0) sm90::tma_store_wait();
  }
}

template <bool H>
cudaError_t launch_16bit(const void* gate, const void* up, const void* wd,
                         void* out, int rows, int m, int h,
                         cudaStream_t stream) {
  constexpr CUtensorMapDataType kType =
      H ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap g_map, u_map, wd_map, out_map;
  const uint64_t a_dims[2] = {(uint64_t)m, (uint64_t)rows};
  const uint64_t a_strides[1] = {(uint64_t)m * 2};
  const uint32_t a_box[2] = {kTK, kTM};
  const uint64_t w_dims[2] = {(uint64_t)h, (uint64_t)m};
  const uint64_t o_dims[2] = {(uint64_t)h, (uint64_t)rows};
  const uint64_t h_strides[1] = {(uint64_t)h * 2};
  const uint32_t w_box[2] = {64, kTK};
  const uint32_t o_box[2] = {64, 64};
  if (!sm90_host::make_map(&g_map, gate, 2, a_dims, a_strides, a_box,
                           kType) ||
      !sm90_host::make_map(&u_map, up, 2, a_dims, a_strides, a_box, kType) ||
      !sm90_host::make_map(&wd_map, wd, 2, w_dims, h_strides, w_box, kType) ||
      !sm90_host::make_map(&out_map, out, 2, o_dims, h_strides, o_box, kType))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      swiglu_down_wgmma<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (rows + kTM - 1) / kTM * ((h + kTN - 1) / kTN);
  const int grid = tiles < sm90_host::sm_count() ? tiles
                                                 : sm90_host::sm_count();
  swiglu_down_wgmma<H><<<grid, 384, kSmem, stream>>>(g_map, u_map, wd_map,
                                                     out_map, rows, m, h);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 route
// One block of 8 warps per (128-row, 128-column) output tile, a loop over
// 32-wide k tiles through shared memory, warp_mma's f32 FMA fragments.
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

cudaError_t launch_f32(const void* gate, const void* up, const void* wd,
                       void* out, int rows, int m, int h,
                       cudaStream_t stream) {
  const dim3 grid(h / kBN, (rows + kBM - 1) / kBM);
  swiglu_down_kernel<float><<<grid, kThreads, 0, stream>>>(
      (const float*)gate, (const float*)up, (const float*)wd, (float*)out,
      rows, m, h);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. gate/up [rows, m], wd
// [m, h], out [rows, h]. Returns the CUDA error of the launch
// (cudaErrorInvalidValue for shapes the kernel does not take: m % 32, h % 128).
extern "C" int swiglu_down_launch(const void* gate, const void* up,
                                  const void* wd, void* out, int rows, int m,
                                  int h, int dtype, void* stream) {
  if (rows < 1 || m < kBKm || m % kBKm || h < kBN || h % kBN ||
      (rows + kBM - 1) / kBM > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_f32(gate, up, wd, out, rows, m, h, s);
  if (dtype == 2)
    return (int)launch_16bit<true>(gate, up, wd, out, rows, m, h, s);
  return (int)launch_16bit<false>(gate, up, wd, out, rows, m, h, s);
}
