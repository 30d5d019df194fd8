// Flash attention split backward for Hopper (sm_90a): a dq pass and a dk/dv
// pass, each free of atomics.
//
// Replaces the two Pallas TPU kernels that paddle_tpu/ops/pallas/
// flash_attention.py's `_bwd_impl` (:472) takes when the fused backward's
// dq scratch rep * sq * d * 4 bytes exceeds 8 MiB (:498-502):
// - `_bwd_dq_kernel` (:283, pallas_call at :515):
//     dq = scale * sum_k dS K,  dS = P (dO V^T - delta),  P = exp(S - lse);
// - `_bwd_dkv_kernel` (:324, pallas_call at :539):
//     dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q, over the rep q heads
//     that share the kv head.
// delta = rowsum(dO * O) and lse come from the caller. Layout [B*H, S, D];
// q head bh reads kv head bh / rep (`_kv_index` :166). Causal masking
// aligns the queries to the end of the keys: row i sees key j when
// j <= i + (Sk - Sq).
//
// Roundings kept from the Pallas kernels: in the dq pass P stays f32 and dS
// is rounded to k's type before dS K (:308); in the dk/dv pass P is rounded
// to do's type before P^T dO (:348) and dS to q's type before dS^T Q
// (:356). The f32 bodies scale each tile's f32 product before it joins the
// sum (:307, :355); the bf16 kernels scale dq and dK once, after the sum.
//
// Bound: at the long-context shape (S = 32768, D = 128, causal) the dq pass
// does 6 * D multiply-add operations per visible (query, key) pair
// (S = QK^T, dP = dO V^T, dS K) and the dk/dv pass 8 * D (the same two
// products, P^T dO and dS^T Q), against 4 * S * D * 2 bytes per head; both
// sit far above the card's ~295 FLOP/byte ridge, so the bf16 tensor-core
// rate bounds them.
//
// bf16: FA3-style kernels on sm90.cuh, three warpgroups a block.
// Warpgroup 0 is the producer (registers cut to 24 by setmaxnreg); warpgroups
// 1 and 2 are consumers (240 registers) that own 64 rows each of the
// block's 128-row tile. Tiles arrive by TMA (128-byte swizzle) on mbarriers;
// TMA's zero fill covers rows past Sq and keys past Sk. exp is one FFMA
// folding scale * log2(e) and -lse * log2(e), then ex2.approx; a query
// row past Sq carries lse = +inf, so its p is 0 without a test. Only tiles
// that straddle the causal diagonal or the ragged key edge are masked.
// - dq (`flash_bwd_dq_wgmma`): one block per (q head, 128-row q tile), the
//   longest causal tiles first. Q and dO are loaded once; K and V stream
//   in 64-key tiles through 3-stage rings up to the causal diagonal (tiles
//   wholly above it are never loaded, the `pl.when` at :312). Per tile a
//   consumer issues S = Q K^T and dP = dO V^T (wgmma SS m64n64k16, K and V
//   K-major), forms P while dP is on the tensor cores, then dS rounded to
//   bf16 in registers: the A operand of dq += dS K (wgmma RS, K read
//   MN-major from the same swizzled tile). dq of tile j runs beside S and
//   dP of tile j + 1. dq stays in f32 registers, is scaled once and is
//   stored by TMA (clipped at Sq) from the consumer's rows of the Q tile.
// - dk/dv (`flash_bwd_dkv_wgmma`): one block per (kv head, 128-key tile),
//   the longest (lowest keys, causal) first. K and V are loaded once; Q and
//   dO stream in 64-row tiles through a 3-stage ring that walks the rep q
//   heads in turn, each from the causal clamp (`_clamp_qi` :227), with no
//   drain between heads. The producer's first warp stages each tile's lse
//   (times log2(e)) and delta in shared memory beside it: those are
//   per-column values here and Sq * 4 bytes need not be TMA-aligned. Each
//   consumer computes transposed, as FA3 does: S^T = K Q^T and dP^T = V dO^T
//   by SS (Q and dO K-major), P^T and dS^T rounded to bf16 in registers as
//   the RS A operands of dV += P^T dO and dK += dS^T Q (dO and Q MN-major
//   from the same tiles). dK (scaled once) and dV leave through the
//   consumer's rows of the K and V tiles by TMA stores clipped at Sk.
// - No atomics and one fixed order: two runs give the same bits.
// f32 keeps the first port's bodies (for the checks):
// - dq: one block of 4 warps per (q head, 64-row q tile), in place of the
//   TPU's sequential third grid dimension over k tiles. Q and dO are loaded
//   once; the block walks the k tiles up to the causal diagonal. Per tile
//   each warp forms S and dP for its 16 rows, stages dS in its own rows of
//   shared memory and adds scale * dS K to a 16 x D accumulator in
//   registers. dq is written once.
// - dk/dv: one block per (kv head, 64-row k tile), the fused kernel of
//   csrc/flash_attention.cu without its dq atomics: dK and dV accumulate
//   in registers while the block walks the rep q heads and their q tiles
//   from the causal clamp.
// - mma.sync-shaped fragments as plain FMAs; every output element is
//   written by one thread after a loop in a fixed order.
// - D in {64, 128}; any Sq, Sk (the ragged last tile is masked).
#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using ptk::from_f32;
using ptk::warp_mma;

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;        // shared-memory row padding (bank spread)
constexpr int kChunk = 32;     // output columns per scaled tile product

template <typename T, int D>
struct DqSmem {
  static constexpr int kLd = D + kPad;     // q, do, k, v rows
  static constexpr int kLdp = kBK + kPad;  // ds rows
  static constexpr size_t kBytes =
      (size_t)(2 * kBQ * kLd + 2 * kBK * kLd + kBQ * kLdp) * sizeof(T);
};

template <typename T, int D>
struct DkvSmem {
  static constexpr int kLd = D + kPad;     // k, v, q, do rows
  static constexpr int kLdp = kBK + kPad;  // p, ds rows
  static constexpr size_t kBytes =
      (size_t)(2 * kBK * kLd + 2 * kBQ * kLd + 2 * kBQ * kLdp) * sizeof(T) +
      2 * kBQ * sizeof(float);
};

__device__ __forceinline__ bool visible(int row, int col, int sq, int sk,
                                        int offset, int causal) {
  return row < sq && col < sk && (!causal || col <= row + offset);
}

// acc[c / 8][.] += scale * (A(16 x K) . B(D x K)^T)[., c] for c < D, one
// chunk of kChunk columns at a time: each tile's product is scaled in f32
// before it joins the sum, as the Pallas kernels do.
template <typename T, int D>
__device__ __forceinline__ void add_scaled(float (*acc)[4], const T* A,
                                           int ar, int ak, const T* B, int bk,
                                           int K, float scale, int lane) {
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    float part[kChunk / 8][4];
    ptk::zero<kChunk / 8>(part);
    warp_mma<T, kChunk / 8>(part, A, ar, ak, B + c0, 1, bk, K, lane);
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + j][e] += scale * part[j][e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int rep, int sq, int sk, float scale, int causal) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kBQ * L::kLd;
  T* ks = dos + kBQ * L::kLd;
  T* vs = ks + kBK * L::kLd;
  T* dss = vs + kBK * L::kLd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int offset = sk - sq;
  const size_t q_base = (size_t)bh * sq * D;
  const T* kp = k + (size_t)(bh / rep) * sk * D;
  const T* vp = v + (size_t)(bh / rep) * sk * D;

  const int qv = min(kBQ, sq - q0);
  ptk::load_rows<T, D, kThreads>(qs, L::kLd, q + q_base + (size_t)q0 * D,
                                 kBQ, qv, tid);
  ptk::load_rows<T, D, kThreads>(dos, L::kLd, dout + q_base + (size_t)q0 * D,
                                 kBQ, qv, tid);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < sq;
    lse_r[h] = in ? lse[(size_t)bh * sq + rows[h]] : 0.f;
    del_r[h] = in ? delta[(size_t)bh * sq + rows[h]] : 0.f;
  }
  float acc[D / 8][4];
  ptk::zero<D / 8>(acc);
  T* ds_rows = dss + warp * 16 * L::kLdp;  // this warp's 16 rows of dS

  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + kBQ, sq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K, V tiles
    const int kv = min(kBK, sk - k0);
    ptk::load_rows<T, D, kThreads>(ks, L::kLd, kp + (size_t)k0 * D, kBK, kv,
                                   tid);
    ptk::load_rows<T, D, kThreads>(vs, L::kLd, vp + (size_t)k0 * D, kBK, kv,
                                   tid);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
    ptk::zero<kBK / 8>(s);
    ptk::zero<kBK / 8>(dp);
    warp_mma<T, kBK / 8>(s, qs + warp * 16 * L::kLd, L::kLd, 1, ks, L::kLd,
                         1, D, lane);
    warp_mma<T, kBK / 8>(dp, dos + warp * 16 * L::kLd, L::kLd, 1, vs,
                         L::kLd, 1, D, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = visible(rows[h], k0 + col, sq, sk, offset, causal)
                            ? expf(s[j][e] * scale - lse_r[h])
                            : 0.f;
        ds_rows[(g + 8 * h) * L::kLdp + col] =
            from_f32<T>(p * (dp[j][e] - del_r[h]));
      }
    __syncwarp();
    // dq += scale * dS K for this warp's 16 rows
    add_scaled<T, D>(acc, ds_rows, L::kLdp, 1, ks, L::kLd, kBK, scale, lane);
  }

  T* dqp = dq + q_base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      T* dst = dqp + (size_t)rows[h] * D + 8 * j + 2 * t;
      dst[0] = from_f32<T>(acc[j][2 * h]);
      dst[1] = from_f32<T>(acc[j][2 * h + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int rep, int sq, int sk,
                         float scale, int causal) {
  using L = DkvSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kBK * L::kLd;
  T* qs = vs + kBK * L::kLd;
  T* dos = qs + kBQ * L::kLd;
  T* ps = dos + kBQ * L::kLd;
  T* dss = ps + kBQ * L::kLdp;
  float* lse_s = reinterpret_cast<float*>(dss + kBQ * L::kLdp);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y, k0 = blockIdx.x * kBK;
  const int offset = sk - sq;
  const size_t kv_base = (size_t)bhk * sk * D;

  ptk::load_rows<T, D, kThreads>(ks, L::kLd, k + kv_base + (size_t)k0 * D,
                                 kBK, min(kBK, sk - k0), tid);
  ptk::load_rows<T, D, kThreads>(vs, L::kLd, v + kv_base + (size_t)k0 * D,
                                 kBK, min(kBK, sk - k0), tid);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  ptk::zero<D / 8>(dk_acc);
  ptk::zero<D / 8>(dv_acc);

  // the first q tile with a row that sees key k0 (causal clamp)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kBQ * kBQ;
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};

  for (int r = 0; r < rep; ++r) {
    const int bh = bhk * rep + r;
    const T* qp = q + (size_t)bh * sq * D;
    const T* dop = dout + (size_t)bh * sq * D;
    for (int q0 = q_begin; q0 < sq; q0 += kBQ) {
      __syncthreads();  // every warp is done with the previous q tile
      const int qv = min(kBQ, sq - q0);
      ptk::load_rows<T, D, kThreads>(qs, L::kLd, qp + (size_t)q0 * D, kBQ,
                                     qv, tid);
      ptk::load_rows<T, D, kThreads>(dos, L::kLd, dop + (size_t)q0 * D, kBQ,
                                     qv, tid);
      for (int i = tid; i < kBQ; i += kThreads) {
        lse_s[i] = i < qv ? lse[(size_t)bh * sq + q0 + i] : 0.f;
        delta_s[i] = i < qv ? delta[(size_t)bh * sq + q0 + i] : 0.f;
      }
      __syncthreads();

      // this warp's 16 q rows against the block's 64 keys
      float s[kBK / 8][4], dp[kBK / 8][4];
      ptk::zero<kBK / 8>(s);
      ptk::zero<kBK / 8>(dp);
      warp_mma<T, kBK / 8>(s, qs + warp * 16 * L::kLd, L::kLd, 1, ks,
                           L::kLd, 1, D, lane);
      warp_mma<T, kBK / 8>(dp, dos + warp * 16 * L::kLd, L::kLd, 1, vs,
                           L::kLd, 1, D, lane);
      const float lse_r[2] = {lse_s[lrow[0]], lse_s[lrow[1]]};
      const float del_r[2] = {delta_s[lrow[0]], delta_s[lrow[1]]};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int col = 8 * j + 2 * t + (e & 1);
          const float p =
              visible(q0 + lrow[h], k0 + col, sq, sk, offset, causal)
                  ? expf(s[j][e] * scale - lse_r[h])
                  : 0.f;
          ps[lrow[h] * L::kLdp + col] = from_f32<T>(p);
          dss[lrow[h] * L::kLdp + col] = from_f32<T>(p * (dp[j][e] -
                                                          del_r[h]));
        }
      __syncthreads();

      // dV += P^T dO and dK += scale * dS^T Q for this warp's 16 keys
      warp_mma<T, D / 8>(dv_acc, ps + warp * 16, 1, L::kLdp, dos, 1, L::kLd,
                         kBQ, lane);
      add_scaled<T, D>(dk_acc, dss + warp * 16, 1, L::kLdp, qs, L::kLd, kBQ,
                       scale, lane);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + lrow[h];
    if (row >= sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = kv_base + (size_t)row * D + 8 * j + 2 * t;
      dk[at] = from_f32<T>(dk_acc[j][2 * h]);
      dk[at + 1] = from_f32<T>(dk_acc[j][2 * h + 1]);
      dv[at] = from_f32<T>(dv_acc[j][2 * h]);
      dv[at + 1] = from_f32<T>(dv_acc[j][2 * h + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bhq, int rep, int sq, int sk, float scale,
                      int causal, cudaStream_t stream) {
  const size_t smem = DqSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, rep, sq, sk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bhk, int rep, int sq, int sk,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = DkvSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBK - 1) / kBK, bhk);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, rep, sq, sk,
      scale, causal);
  return cudaGetLastError();
}

// --------------------------------------------------- bf16 (TMA + wgmma)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float f32_inf() {
  return __int_as_float(0x7f800000);
}

// A consumer's accumulator (rows 16 * warp + g + 8h of its 64, columns
// 8j + 2t + {0, 1}) into its rows of a swizzled [128][D] bf16 tile made of
// 64-column boxes `box` bytes apart, each value times `mul`.
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* tile, uint32_t box,
                                           const float (&acc)[D / 2],
                                           float mul, int c, int warp, int g,
                                           int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * c + 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int chunk = (j & 7) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(tile + (j >> 3) * box + row * 128 +
                                   chunk * 16 + 4 * t4) =
          sm90::pack_bf16x2(acc[4 * j + 2 * h] * mul,
                            acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// acc[D/2] += A . B over k = 64 (four k16 steps): A the bf16 fragments
// `a`, B an MN-major [64][D] tile at `b` whose 64-column boxes lie `box`
// bytes apart.
template <int D>
__device__ __forceinline__ void rs_k64(float (&acc)[D / 2],
                                       const uint32_t (&a)[4][4], uint32_t b,
                                       uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = sm90::desc_b128(b + kk * 16 * 128, box, 1024);
    if constexpr (D == 128)
      sm90::wgmma_rs_n128<1>(acc, a[kk], bd, 1);
    else
      sm90::wgmma_rs_n64<1>(acc, a[kk], bd, 1);
  }
}

// d[32] = A . B^T over k = D: A the 64 rows at `a` of a K-major tile whose
// 64-column boxes lie `a_box` bytes apart, B a K-major [64][D] tile at `b`
// with boxes `b_box` apart.
template <int D>
__device__ __forceinline__ void ss_n64(float (&d)[32], uint32_t a,
                                       uint32_t a_box, uint32_t b,
                                       uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    sm90::wgmma_ss_n64<0>(
        d, sm90::desc_b128(a + (kk / 4) * a_box + col, 16, 1024),
        sm90::desc_b128(b + (kk / 4) * b_box + col, 16, 1024), kk > 0);
  }
}

// The 16 bf16 A fragments of a 64 x 64 accumulator, rounded in registers.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = sm90::pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int D>
struct DqWg {
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kQBox = 128 * 128;       // [128 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr uint32_t kKBox = 64 * 128;        // [64 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr int kStages = 3;                  // of K and of V
  static constexpr uint32_t kDoOff = kQTile;
  static constexpr uint32_t kKOff = 2 * kQTile;
  static constexpr uint32_t kVOff = kKOff + kStages * kKTile;
  static constexpr uint32_t kBarOff = kVOff + kStages * kKTile;
  // barriers: K full/empty, V full/empty (kStages each), then Q and dO
  static constexpr size_t kSmem = kBarOff + (4 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap dq_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int rep, int sq,
                       int sk, float scale, int causal) {
  using L = DqWg<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t k_full = base + L::kBarOff, k_empty = k_full + 8 * S,
                 v_full = k_empty + 8 * S, v_empty = v_full + 8 * S,
                 q_bar = v_empty + 8 * S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // longest tiles first
  const int offset = sk - sq;
  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + 128, sq) + offset);
  const int n_kt = k_end > 0 ? (k_end + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(k_full + 8 * i, 1);
      sm90::mbar_init(v_full + 8 * i, 1);
      sm90::mbar_init(k_empty + 8 * i, 8);  // lane 0 of each consumer warp
      sm90::mbar_init(v_empty + 8 * i, 8);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_bar, 2 * L::kQTile);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        sm90::tma_load_3d(base + b * L::kQBox, &q_map, q_bar, 64 * b, q0, bh);
        sm90::tma_load_3d(base + L::kDoOff + b * L::kQBox, &do_map, q_bar,
                          64 * b, q0, bh);
      }
      const int bhk = bh / rep;
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        const uint32_t par = ((j / S) & 1) ^ 1;
        sm90::mbar_wait(k_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(k_full + 8 * st, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kKOff + st * L::kKTile + b * L::kKBox,
                            &k_map, k_full + 8 * st, 64 * b, 64 * j, bhk);
        sm90::mbar_wait(v_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(v_full + 8 * st, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kVOff + st * L::kKTile + b * L::kKBox,
                            &v_map, v_full + 8 * st, 64 * b, 64 * j, bhk);
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::reg_alloc<240>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * c;  // this consumer's first row
    const int rows[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
    // k tiles that hold a key some row of this consumer sees
    int n_wg = n_kt;
    if (wq0 >= sq)
      n_wg = 0;
    else if (causal)
      n_wg = max(0, min(sk, min(wq0 + 64, sq) + offset) + 63) / 64;
    const float sl2 = scale * kLog2e;
    // lse * log2(e) (+inf past Sq: p = 0) and delta of this thread's rows
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < sq;
      lse2[h] = in ? lse[(size_t)bh * sq + rows[h]] * kLog2e : f32_inf();
      del[h] = in ? delta[(size_t)bh * sq + rows[h]] : 0.f;
    }

    float dq[D / 2], s[32], dp[32];
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    auto release = [&](uint32_t bar, int j) {
      if (lane == 0) sm90::mbar_arrive(bar + 8 * (j % S));
    };
    const uint32_t q_rows = base + c * 64 * 128;  // this consumer's Q rows
    const uint32_t do_rows = base + L::kDoOff + c * 64 * 128;

    sm90::mbar_wait(q_bar, 0);
    for (int j = 0; j < n_wg; ++j) {
      const int st = j % S;
      const uint32_t ks = base + L::kKOff + st * L::kKTile;
      const uint32_t vs = base + L::kVOff + st * L::kKTile;
      sm90::mbar_wait(k_full + 8 * st, (j / S) & 1);
      sm90::wgmma_fence();
      ss_n64<D>(s, q_rows, L::kQBox, ks, L::kKBox);
      sm90::wgmma_commit();
      sm90::mbar_wait(v_full + 8 * st, (j / S) & 1);
      ss_n64<D>(dp, do_rows, L::kQBox, vs, L::kKBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dq of tile j - 1 and S of tile j are done
      sm90::fence_regs(s);
      if (j > 0) {
        sm90::fence_regs(dsa);
        release(k_empty, j - 1);
      }
      const int k0 = 64 * j;
      const bool masked =
          k0 + 64 > sk || (causal && k0 + 63 > wq0 + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float p = sm90::ex2_approx(fmaf(s[i], sl2, -lse2[h]));
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (col >= sk || (causal && col > rows[h] + offset)) p = 0.f;
        }
        s[i] = p;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      release(v_empty, j);
      // dS = P (dP - delta), rounded to k's type (:306-310)
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del[(i >> 1) & 1]);
      pack_frags(dsa, dp);
      sm90::wgmma_fence();
      rs_k64<D>(dq, dsa, ks, L::kKBox);  // dq += dS K, K MN-major
      sm90::wgmma_commit();
    }
    if (n_wg > 0) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dsa);
      release(k_empty, n_wg - 1);
    }
    for (int j = n_wg; j < n_kt; ++j) {  // tiles none of these rows sees
      sm90::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
      release(k_empty, j);
      sm90::mbar_wait(v_full + 8 * (j % S), (j / S) & 1);
      release(v_empty, j);
    }

    // epilogue: scale * dq into this consumer's rows of the Q tile, then TMA
    stage_rows<D>(smem, L::kQBox, dq, scale, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0 && wq0 < sq) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_store_3d(&dq_map, q_rows + b * L::kQBox, 64 * b, wq0, bh);
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int D>
struct DkvWg {
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kKBox = 128 * 128;       // [128 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr uint32_t kQBox = 64 * 128;        // [64 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr int kStages = 3;                  // of Q, dO and rows
  static constexpr uint32_t kVOff = kKTile;
  static constexpr uint32_t kQOff = 2 * kKTile;
  static constexpr uint32_t kDoOff = kQOff + kStages * kQTile;
  // per stage: 64 lse * log2(e), then 64 delta (f32)
  static constexpr uint32_t kRowOff = kDoOff + kStages * kQTile;
  static constexpr uint32_t kBarOff = kRowOff + kStages * 512;
  // barriers: full/empty (kStages each), then K and V
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap dk_map,
                        const __grid_constant__ CUtensorMap dv_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int rep, int sq,
                        int sk, float scale, int causal) {
  using L = DkvWg<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t full = base + L::kBarOff, empty = full + 8 * S,
                 kv_bar = empty + 8 * S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bhk = blockIdx.x, k0 = blockIdx.y * 128;  // lowest keys first
  const int offset = sk - sq;
  // the first q tile with a row that sees key k0 (causal clamp); the walk
  // is rep heads x n_qt tiles
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / 64 * 64;
  const int n_qt = (sq - q_begin + 63) / 64;
  const int n_items = rep * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(full + 8 * i, 32);  // the producer's first warp
      sm90::mbar_init(empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<24>();
    if (tid < 32) {
      if (tid == 0) {
        sm90::mbar_arrive_expect_tx(kv_bar, 2 * L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_load_3d(base + b * L::kKBox, &k_map, kv_bar, 64 * b, k0,
                            bhk);
          sm90::tma_load_3d(base + L::kVOff + b * L::kKBox, &v_map, kv_bar,
                            64 * b, k0, bhk);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % S;
        const int bh = bhk * rep + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * 64;
        sm90::mbar_wait(empty + 8 * st, ((it / S) & 1) ^ 1);
        // lse * log2(e) (+inf past Sq: p = 0) and delta of the tile's rows
        float* rows = reinterpret_cast<float*>(smem + L::kRowOff + st * 512);
        for (int i = tid; i < 64; i += 32) {
          const bool in = q0 + i < sq;
          const size_t at = (size_t)bh * sq + q0 + i;
          rows[i] = in ? lse[at] * kLog2e : f32_inf();
          rows[64 + i] = in ? delta[at] : 0.f;
        }
        if (tid == 0) {
          sm90::mbar_arrive_expect_tx(full + 8 * st, 2 * L::kQTile);
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load_3d(base + L::kQOff + st * L::kQTile + b * L::kQBox,
                              &q_map, full + 8 * st, 64 * b, q0, bh);
            sm90::tma_load_3d(base + L::kDoOff + st * L::kQTile +
                                  b * L::kQBox,
                              &do_map, full + 8 * st, 64 * b, q0, bh);
          }
        } else {
          sm90::mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::reg_alloc<240>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kc0 = k0 + 64 * c;  // this consumer's first key
    const int keys[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};
    const float sl2 = scale * kLog2e;
    const uint32_t k_rows = base + c * 64 * 128;  // this consumer's keys
    const uint32_t v_rows = base + L::kVOff + c * 64 * 128;

    float dk[D / 2], dv[D / 2], s[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % S;
      const int q0 = q_begin + (it % n_qt) * 64;
      sm90::mbar_wait(full + 8 * st, (it / S) & 1);
      // skip a tile none of this consumer's keys is seen from (or keys
      // past Sk only)
      if (kc0 < sk && (!causal || kc0 <= q0 + 63 + offset)) {
        const uint32_t qs = base + L::kQOff + st * L::kQTile;
        const uint32_t dos = base + L::kDoOff + st * L::kQTile;
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRowOff + st * 512);
        sm90::wgmma_fence();
        ss_n64<D>(s, k_rows, L::kKBox, qs, L::kQBox);  // S^T = K Q^T
        sm90::wgmma_commit();
        ss_n64<D>(dp, v_rows, L::kKBox, dos, L::kQBox);  // dP^T = V dO^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        // row = key, column = query: visible when key <= query + offset
        const bool masked = causal && kc0 + 63 > q0 + offset;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = sm90::ex2_approx(
                fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x)));
            if (masked &&
                keys[e >> 1] > q0 + 8 * j + 2 * t4 + (e & 1) + offset)
              p = 0.f;
            s[i] = p;
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(rows + 64 + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dp[i] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
          }
        }
        // P^T rounded to do's type (:347-350), dS^T to q's type (:354-358)
        pack_frags(pa, s);
        pack_frags(dsa, dp);
        sm90::wgmma_fence();
        rs_k64<D>(dv, pa, dos, L::kQBox);   // dV += P^T dO, dO MN-major
        rs_k64<D>(dk, dsa, qs, L::kQBox);   // dK += dS^T Q, Q MN-major
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
      }
      if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
    }

    // epilogue: scale * dK and dV into this consumer's rows of the K and V
    // tiles, then TMA (clipped at Sk)
    stage_rows<D>(smem, L::kKBox, dk, scale, c, warp, g, t4);
    stage_rows<D>(smem + L::kVOff, L::kKBox, dv, 1.f, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0 && kc0 < sk) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        sm90::tma_store_3d(&dk_map, k_rows + b * L::kKBox, 64 * b, kc0, bhk);
        sm90::tma_store_3d(&dv_map, v_rows + b * L::kKBox, 64 * b, kc0, bhk);
      }
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bhq, int rep,
                           int sq, int sk, float scale, int causal,
                           cudaStream_t stream) {
  using L = DqWg<D>;
  const int bhk = bhq / rep;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, D, 128) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, D, 128) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, D, 64) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, D, 64) ||
      !sm90_host::map_rows(&dq_map, dq, bhq, sq, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + 127) / 128);
  flash_bwd_dq_wgmma<D><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, (const float*)lse,
      (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bhk,
                            int rep, int sq, int sk, float scale, int causal,
                            cudaStream_t stream) {
  using L = DkvWg<D>;
  const int bhq = bhk * rep;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, D, 64) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, D, 64) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, D, 128) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, D, 128) ||
      !sm90_host::map_rows(&dk_map, dk, bhk, sk, D, 64) ||
      !sm90_host::map_rows(&dv_map, dv, bhk, sk, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, (sk + 127) / 128);
  flash_bwd_dkv_wgmma<D><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, (const float*)lse,
      (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

bool valid_shape(int bh, int rep, int sq, int sk, int head_dim, int dtype) {
  return bh >= 1 && bh <= 65535 && rep >= 1 && sq >= 1 && sk >= 1 &&
         (head_dim == 64 || head_dim == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/do/dq [bhq, sq, D], k/v
// [bhq/rep, sk, D], lse/delta [bhq, sq] f32. Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for shapes it does not take).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bhq, int rep, int sq,
    int sk, int head_dim, float scale, int causal, int dtype, void* stream) {
  if (!valid_shape(bhq, rep, sq, sk, head_dim, dtype) || bhq % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(head_dim == 64
                     ? launch_dq<float, 64>(q, k, v, dout, lse, delta, dq,
                                            bhq, rep, sq, sk, scale, causal, s)
                     : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq,
                                             bhq, rep, sq, sk, scale, causal,
                                             s));
  return (int)(head_dim == 64
                   ? launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, bhq,
                                        rep, sq, sk, scale, causal, s)
                   : launch_dq_bf16<128>(q, k, v, dout, lse, delta, dq, bhq,
                                         rep, sq, sk, scale, causal, s));
}

// dk/dv [bhk, sk, D]; q/do [bhk*rep, sq, D].
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bhk, int rep,
    int sq, int sk, int head_dim, float scale, int causal, int dtype,
    void* stream) {
  if (!valid_shape(bhk, rep, sq, sk, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(head_dim == 64
                     ? launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk,
                                             dv, bhk, rep, sq, sk, scale,
                                             causal, s)
                     : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk,
                                              dv, bhk, rep, sq, sk, scale,
                                              causal, s));
  return (int)(head_dim == 64
                   ? launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv,
                                         bhk, rep, sq, sk, scale, causal, s)
                   : launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv,
                                          bhk, rep, sq, sk, scale, causal,
                                          s));
}
