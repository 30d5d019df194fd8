// Flash attention forward and fused backward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// - the forward `_fwd_kernel` (:113, pallas_call in `_fwd_call` at :248):
//     o = softmax(q k^T * scale, causal mask) v,  lse = m + log(l);
// - the fused single-pass backward `_bwd_fused_kernel` (:373, pallas_call
//   in `_bwd_fused` at :581): dq, dk and dv from (q, k, v, do, lse, delta)
//   with delta = rowsum(do * o) computed by the caller.
// Layout [B*H, S, D]; q head bh reads kv head bh / rep (rep = Hq / Hkv),
// which is the JAX package's `_kv_index`. Causal masking aligns the queries
// to the end of the keys: row i sees key j when j <= i + (Sk - Sq).
//
// Bound: at the training shapes (S = 2048, D = 128) both kernels do about
// S/2 multiply-adds per byte they must move, far above the card's
// ~295 FLOP/byte ridge, so the bf16 tensor-core rate bounds them.
//
// Forward, bf16: an FA3-style kernel (building blocks in sm90.cuh).
// - One block per (bh, 128-row q tile), the longest causal q tiles first.
//   The TPU's sequential grid dimension over k tiles becomes a loop; tiles
//   wholly above the causal diagonal are never loaded (the `pl.when` at
//   :149).
// - Warpgroup 0 is the producer: one thread loads the Q tile once by TMA
//   and keeps 2-stage rings of K tiles and of V tiles (128 x D each) in
//   flight, each tile completing on its own mbarrier. Its registers drop
//   to 24 (setmaxnreg).
// - Warpgroups 1 and 2 are consumers with 240 registers, 64 q rows each:
//   S = Q K^T by wgmma SS m64n128k16 (K a K-major B); the online softmax
//   on the accumulator fragment in f32, with scale and log2(e) folded into
//   one FFMA before ex2.approx, and the row max and sum reduced over the 4
//   threads of a quad; P rounded to v's type (:141) in registers, which
//   are the A operand of O += P V by wgmma RS m64nDk16 with V an MN-major
//   B. Inside a consumer, S of tile j is issued with P V of tile j - 1 and
//   the softmax of tile j runs while P V is on the tensor cores (FA3's
//   intra-warpgroup overlap). K is released once S is done, V once P V is.
//   A consumer skips the k tiles that none of its rows sees.
// - Only the diagonal tiles and a ragged last k tile are masked: masked
//   positions carry the JAX package's NEG_INF = -1e30 in the max and
//   contribute p = 0. A row that sees no key gets o = 0 and lse = -1e30
//   (the l == 0 guards of :157-161). TMA's zero fill covers rows past Sq
//   and keys past Sk.
// - Epilogue: O / l rounded to bf16, staged in the consumer's own rows of
//   the Q tile and stored by TMA (clipped at Sq); lse by plain stores.
// - No atomics and a fixed order: runs repeat bit for bit.
// Forward, f32: the first port's body (one block of 4 warps per 64-row q
// tile, mma.sync-shaped fragments as FMAs), kept for the f32 checks.
// Backward, bf16 (`flash_bwd_wgmma`): the split dk/dv kernel of
// csrc/flash_attention_split.cu with dq added, on sm90.cuh.
// - One block per (b * Hkv, 128-key tile), the lowest keys (the longest
//   causal walks) first. Warpgroup 0 is the producer (24 registers): K and
//   V are loaded once by TMA; Q and dO stream in 64-row tiles through a
//   ring (2 stages at D = 128, 4 at D = 64) that walks the rep q heads of
//   the kv head, each from the causal clamp (`_clamp_qi` :227), with each
//   tile's lse (times log2(e)) and delta staged beside it.
// - Warpgroups 1 and 2 are consumers (240 registers) with 64 keys each.
//   Per q tile, transposed as FA3 does: S^T = K Q^T and dP^T = V dO^T by
//   SS wgmma, P^T (rounded to do's type, :415) and dS^T (rounded to q's
//   type, :422) in registers as the RS A operands of dV += P^T dO and
//   dK += dS^T Q.
// - dq (the fused extra, :425-428): each consumer writes its bf16 dS^T
//   rows into a shared [128 keys][64 q] tile (two, used in turn), and after
//   a named barrier computes a [64 q x 64] f32 product dQ = dS K by SS
//   wgmma, dS read MN-major from that tile and K MN-major from the
//   resident K tile. At D = 128 consumer c takes columns 64c..64c+63 over
//   all 128 keys; at D = 64 all columns over its own 64 keys. On the TPU
//   dq accumulated in VMEM scratch across the sequential grid; here blocks
//   run in no order, so the product, times scale, is staged in shared
//   memory (f32, 128-byte swizzled) and one thread adds it into the zeroed
//   [B*Hq, Sq, D] f32 workspace by a TMA reduce-add
//   (cp.reduce.async.bulk.tensor), clipped at Sq; the caller casts it to
//   q's type. No atomics from registers, but the order of the adds across
//   blocks changes from run to run, so two runs need not give the same
//   bits (the split pair does).
// - dK (scaled once) and dV leave through the consumer's rows of the K and
//   V tiles by TMA stores clipped at Sk.
// Backward, f32: the first port's body (`flash_bwd_kernel`), kept for the
// f32 checks.
// - One block per (b * Hkv, 64-row k tile). dK and dV of the tile
//   accumulate in f32 registers while the block walks the rep q heads of
//   its kv head and their q tiles at or below the diagonal. Per q tile it
//   forms S and P = exp(S*scale - lse), dP = dO V^T and dS = P (dP - delta)
//   in registers, stages P and dS in shared memory, and adds P^T dO to dV
//   and dS^T Q to dK; scale * dS K goes by f32 atomicAdd into the zeroed
//   workspace.
// - mma.sync-shaped fragments as plain FMAs.
// - D in {64, 128}; any Sq, Sk (the ragged last tile is masked).
#include "sm90.cuh"
#include "warp_tile.cuh"

namespace {

using ptk::from_f32;
using ptk::to_f32;
using ptk::warp_mma;

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;        // shared-memory row padding (bank spread)
constexpr float kNegInf = -1e30f;

template <typename T, int D>
struct FwdSmem {
  static constexpr int kLd = D + kPad;     // q, k, v rows
  static constexpr int kLdp = kBK + kPad;  // p rows
  static constexpr size_t kBytes =
      (size_t)(kBQ * kLd + 2 * kBK * kLd + kBQ * kLdp) * sizeof(T);
};

template <typename T, int D>
struct BwdSmem {
  static constexpr int kLd = D + kPad;     // k, v, q, do rows
  static constexpr int kLdp = kBK + kPad;  // p, ds rows
  static constexpr size_t kBytes =
      (size_t)(2 * kBK * kLd + 2 * kBQ * kLd + 2 * kBQ * kLdp) * sizeof(T) +
      2 * kBQ * sizeof(float);
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool visible(int row, int col, int sq, int sk,
                                        int offset, int causal) {
  return row < sq && col < sk && (!causal || col <= row + offset);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int rep, int sq, int sk,
                     float scale, int causal) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBQ * L::kLd;
  T* vs = ks + kBK * L::kLd;
  T* ps = vs + kBK * L::kLd;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int offset = sk - sq;
  const T* qp = q + (size_t)bh * sq * D;
  const T* kp = k + (size_t)(bh / rep) * sk * D;
  const T* vp = v + (size_t)(bh / rep) * sk * D;

  ptk::load_rows<T, D, kThreads>(qs, L::kLd, qp + (size_t)q0 * D, kBQ,
                                 min(kBQ, sq - q0), tid);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  ptk::zero<D / 8>(acc);

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

    float s[kBK / 8][4];
    ptk::zero<kBK / 8>(s);
    warp_mma<T, kBK / 8>(s, qs + warp * 16 * L::kLd, L::kLd, 1, ks, L::kLd,
                         1, D, lane);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float x =
            visible(rows[e >> 1], col, sq, sk, offset, causal)
                ? s[j][e] * scale
                : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p = visible(rows[e >> 1], col, sq, sk, offset, causal)
                            ? expf(s[j][e] - m[e >> 1])
                            : 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // P (rounded to v's type) through shared memory as the A operand
    T* prow = ps + (warp * 16 + g) * L::kLdp;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        prow[(e >> 1) * 8 * L::kLdp + 8 * j + 2 * t + (e & 1)] =
            from_f32<T>(s[j][e]);
    __syncwarp();
    warp_mma<T, D / 8>(acc, ps + warp * 16 * L::kLdp, L::kLdp, 1, vs, 1,
                       L::kLd, kBK, lane);
  }

  T* op = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= sq) continue;
    const float ls = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      T* dst = op + (size_t)rows[h] * D + 8 * j + 2 * t;
      dst[0] = from_f32<T>(acc[j][2 * h] / ls);
      dst[1] = from_f32<T>(acc[j][2 * h + 1] / ls);
    }
    if (t == 0) lse[(size_t)bh * sq + rows[h]] = m[h] + logf(ls);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int rep, int sq, int sk, float scale,
                     int causal) {
  using L = BwdSmem<T, D>;
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
    float* dqp = dq_acc + (size_t)bh * sq * D;
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
          const float ds = p * (dp[j][e] - del_r[h]);
          ps[lrow[h] * L::kLdp + col] = from_f32<T>(p);
          dss[lrow[h] * L::kLdp + col] = from_f32<T>(ds);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for this warp's 16 keys
      warp_mma<T, D / 8>(dv_acc, ps + warp * 16, 1, L::kLdp, dos, 1, L::kLd,
                         kBQ, lane);
      warp_mma<T, D / 8>(dk_acc, dss + warp * 16, 1, L::kLdp, qs, 1, L::kLd,
                         kBQ, lane);
      // dQ += scale * dS K for this warp's 16 q rows, 32 columns at a time
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32) {
        float part[4][4];
        ptk::zero<4>(part);
        warp_mma<T, 4>(part, dss + warp * 16 * L::kLdp, L::kLdp, 1, ks + c0,
                       1, L::kLd, kBK, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + lrow[h];
          if (row >= sq) continue;
          float* dst = dqp + (size_t)row * D + c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            atomicAdd(dst + 8 * j, scale * part[j][2 * h]);
            atomicAdd(dst + 8 * j + 1, scale * part[j][2 * h + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + lrow[h];
    if (row >= sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = kv_base + (size_t)row * D + 8 * j + 2 * t;
      dk[at] = from_f32<T>(scale * dk_acc[j][2 * h]);
      dk[at + 1] = from_f32<T>(scale * dk_acc[j][2 * h + 1]);
      dv[at] = from_f32<T>(dv_acc[j][2 * h]);
      dv[at + 1] = from_f32<T>(dv_acc[j][2 * h + 1]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bhq, int rep, int sq, int sk,
                       float scale, int causal, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value,
                "bf16 takes flash_fwd_wgmma (launch_fwd_bf16)");
  const size_t smem = FwdSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, rep, sq, sk,
      scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq_acc, void* dk, void* dv, int bhk, int rep,
                       int sq, int sk, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = BwdSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBK - 1) / kBK, bhk);
  flash_bwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (float*)dq_acc, (T*)dk, (T*)dv,
      rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

// ----------------------------------------------- forward, bf16 (wgmma)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Fa3 {
  static constexpr int kBoxes = D / 64;               // 64-column boxes
  static constexpr uint32_t kBox = 128 * 64 * 2;      // [128 rows][64], 16 KB
  static constexpr uint32_t kTile = kBoxes * kBox;    // a Q, K or V tile
  static constexpr int kStages = 2;                   // of K and of V
  static constexpr uint32_t kKOff = kTile;
  static constexpr uint32_t kVOff = kKOff + kStages * kTile;
  static constexpr uint32_t kBarOff = kVOff + kStages * kTile;
  // barriers: K full/empty, V full/empty (kStages each), then Q
  static constexpr size_t kSmem = kBarOff + (4 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map,
                    float* __restrict__ lse, int rep, int sq, int sk,
                    float scale, int causal) {
  using L = Fa3<D>;
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
  const int n_kt = k_end > 0 ? (k_end + 127) / 128 : 0;

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
      sm90::mbar_arrive_expect_tx(q_bar, L::kTile);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_load_3d(base + b * L::kBox, &q_map, q_bar, 64 * b, q0, bh);
      const int bhk = bh / rep;
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        const uint32_t par = ((j / S) & 1) ^ 1;
        sm90::mbar_wait(k_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(k_full + 8 * st, L::kTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kKOff + st * L::kTile + b * L::kBox,
                            &k_map, k_full + 8 * st, 64 * b, 128 * j, bhk);
        sm90::mbar_wait(v_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(v_full + 8 * st, L::kTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kVOff + st * L::kTile + b * L::kBox,
                            &v_map, v_full + 8 * st, 64 * b, 128 * j, bhk);
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
      n_wg = max(0, min(sk, min(wq0 + 64, sq) + offset) + 127) / 128;
    const float sl2 = scale * kLog2e;

    float o[D / 2], s[64];
    uint32_t pa[8][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running row max of s * scale * log2(e), and row sum of p
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    auto release = [&](uint32_t bar, int j) {
      if (lane == 0) sm90::mbar_arrive(bar + 8 * (j % S));
    };
    // issue S = Q K_j^T: 64 rows x 128 keys, k over D in steps of 16
    auto scores = [&](int j) {
      const uint32_t ks = base + L::kKOff + (j % S) * L::kTile;
      sm90::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk / 4) * L::kBox + (kk % 4) * 32;
        sm90::wgmma_ss_n128<0>(
            s, sm90::desc_b128(base + koff + c * 64 * 128, 16, 1024),
            sm90::desc_b128(ks + koff, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // issue O += P V_j: k over the 128 keys in steps of 16, V MN-major
    auto pv = [&](int j) {
      const uint32_t vs = base + L::kVOff + (j % S) * L::kTile;
      sm90::mbar_wait(v_full + 8 * (j % S), (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t vd = sm90::desc_b128(vs + kk * 16 * 128, L::kBox, 1024);
        if constexpr (D == 128)
          sm90::wgmma_rs_n128<1>(o, pa[kk], vd, 1);
        else
          sm90::wgmma_rs_n64<1>(o, pa[kk], vd, 1);
      }
      sm90::wgmma_commit();
    };
    // the online softmax of tile j on s: p (f32) into s, the new row max
    // into m, the rescale of the old sums into alpha, the row sums of p
    // into rs
    auto softmax = [&](int j, float(&alpha)[2], float(&rs)[2]) {
      const int k0 = 128 * j;
      const bool masked =
          k0 + 128 > sk || (causal && k0 + 127 > wq0 + offset);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = rows[(i >> 1) & 1];
          if (col >= sk || (causal && col > row + offset)) s[i] = kNegInf;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]) * sl2);
        alpha[h] = sm90::ex2_approx(m[h] - mn);
        m[h] = mn;
        rs[h] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        const float p = masked && s[i] == kNegInf
                            ? 0.f
                            : sm90::ex2_approx(fmaf(s[i], sl2, -m[h]));
        s[i] = p;
        rs[h] += p;
      }
    };
    // P rounded to v's type (:141): the A fragments of O += P V
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] =
              sm90::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    sm90::mbar_wait(q_bar, 0);
    if (n_wg > 0) {
      float alpha[2], rs[2];
      scores(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      release(k_empty, 0);
      softmax(0, alpha, rs);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = quad_sum(rs[h]);
      pack_p();
      // S of tile j runs beside P V of tile j - 1; the softmax of tile j
      // runs while P V of tile j - 1 is still on the tensor cores
      for (int j = 1; j < n_wg; ++j) {
        scores(j);
        pv(j - 1);
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        release(k_empty, j);
        softmax(j, alpha, rs);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(pa);
        release(v_empty, j - 1);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
        pack_p();
      }
      pv(n_wg - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      release(v_empty, n_wg - 1);
    }
    for (int j = n_wg; j < n_kt; ++j) {  // tiles none of these rows sees
      sm90::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
      release(k_empty, j);
      sm90::mbar_wait(v_full + 8 * (j % S), (j / S) & 1);
      release(v_empty, j);
    }

    // epilogue: O / l into this consumer's rows of the Q tile, then TMA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ls = l[h] == 0.f ? 1.f : l[h];
      const float inv = 1.f / ls;
      if (t4 == 0 && rows[h] < sq)
        lse[(size_t)bh * sq + rows[h]] =
            l[h] == 0.f ? kNegInf : (m[h] + log2f(ls)) * kLn2;
      const int row = 64 * c + 16 * warp + g + 8 * h;  // row in the tile
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int chunk = (j & 7) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(smem + (j >> 3) * L::kBox + row * 128 +
                                     chunk * 16 + 4 * t4) =
            sm90::pack_bf16x2(o[4 * j + 2 * h] * inv,
                              o[4 * j + 2 * h + 1] * inv);
      }
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_store_3d(&o_map, base + b * L::kBox + c * 64 * 128, 64 * b,
                           wq0, bh);
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int D>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bhq, int rep, int sq,
                            int sk, float scale, int causal,
                            cudaStream_t stream) {
  using L = Fa3<D>;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, D, 128) ||
      !sm90_host::map_rows(&k_map, k, bhq / rep, sk, D, 128) ||
      !sm90_host::map_rows(&v_map, v, bhq / rep, sk, D, 128) ||
      !sm90_host::map_rows(&o_map, o, bhq, sq, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + 127) / 128);
  flash_fwd_wgmma<D><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, o_map, (float*)lse, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------ fused backward, bf16 (wgmma)
template <int D>
struct BwdWg {
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kKBox = 128 * 128;       // [128 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr uint32_t kQBox = 64 * 128;        // [64 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr int kStages = D == 128 ? 2 : 4;   // of Q, dO and rows
  static constexpr uint32_t kDsTile = 128 * 128;     // dS^T [128 keys][64 q]
  static constexpr uint32_t kDqBox = 64 * 128;       // [64 q rows][32] f32
  static constexpr uint32_t kVOff = kKTile;
  static constexpr uint32_t kQOff = 2 * kKTile;
  static constexpr uint32_t kDoOff = kQOff + kStages * kQTile;
  static constexpr uint32_t kDsOff = kDoOff + kStages * kQTile;  // 2 tiles
  static constexpr uint32_t kDqOff = kDsOff + 2 * kDsTile;  // 2 boxes each
  // per stage: 64 lse * log2(e), then 64 delta (f32)
  static constexpr uint32_t kRowOff = kDqOff + 2 * 2 * kDqBox;
  static constexpr uint32_t kBarOff = kRowOff + kStages * 512;
  // barriers: full/empty (kStages each), then K and V
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const __grid_constant__ CUtensorMap dk_map,
                    const __grid_constant__ CUtensorMap dv_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int rep, int sq, int sk,
                    float scale, int causal) {
  using L = BwdWg<D>;
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
          rows[i] = in ? lse[at] * sm90::kLog2e : sm90::f32_inf();
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
    const float sl2 = scale * sm90::kLog2e;
    const uint32_t k_rows = base + c * 64 * 128;  // this consumer's keys
    const uint32_t v_rows = base + L::kVOff + c * 64 * 128;
    // dQ of a q tile = dS K, 64 columns a consumer: at D = 128 consumer c
    // takes columns 64c.. over all 128 keys (it reads the other's dS^T
    // rows); at D = 64 every column over its own 64 keys (both add into the
    // same rows). Either way a [64 x 64] f32 product.
    constexpr int kDqSteps = D == 128 ? 8 : 4;       // k16 steps over keys
    const int dq_key0 = D == 128 ? 0 : 64 * c;
    const int dq_col = D == 128 ? 64 * c : 0;
    const uint32_t dq_b = base + (D == 128 ? c * L::kKBox : 0) + dq_key0 * 128;
    // the dS^T tiles are shared by both consumers at D = 128
    const int ds_bar = D == 128 ? 3 : 1 + c, ds_threads = D == 128 ? 256 : 128;
    uint8_t* stage = smem + L::kDqOff + c * 2 * L::kDqBox;

    float dk[D / 2], dv[D / 2], s[32], dp[32], dq[32];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % S;
      const int bh = bhk * rep + it / n_qt;
      const int q0 = q_begin + (it % n_qt) * 64;
      const uint32_t qs = base + L::kQOff + st * L::kQTile;
      const uint32_t dos = base + L::kDoOff + st * L::kQTile;
      sm90::mbar_wait(full + 8 * st, (it / S) & 1);
      // some key of this consumer is seen from the tile (and lies before Sk)
      const bool active = kc0 < sk && (!causal || kc0 <= q0 + 63 + offset);
      if (active) {
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRowOff + st * 512);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;  // not carried
        sm90::wgmma_fence();
        sm90::ss_n64<D>(s, k_rows, L::kKBox, qs, L::kQBox);  // S^T = K Q^T
        sm90::wgmma_commit();
        sm90::ss_n64<D>(dp, v_rows, L::kKBox, dos, L::kQBox);  // dP^T = V dO^T
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
        // P^T rounded to do's type (:415), dS^T to q's type (:422) and so
        // to k's type for dQ (:428; the two types are the same here)
        sm90::pack_frags(pa, s);
        sm90::pack_frags(dsa, dp);
        sm90::wgmma_fence();
        sm90::rs_k64<D>(dv, pa, dos, L::kQBox);  // dV += P^T dO, dO MN-major
        sm90::rs_k64<D>(dk, dsa, qs, L::kQBox);  // dK += dS^T Q, Q MN-major
        sm90::wgmma_commit();
      }
      // this consumer's 64 rows of the item's dS^T tile (zero where none of
      // its keys is seen); the tile of item it - 2 is free: both consumers
      // finished its dQ products before the dS^T barrier of item it - 1
      uint8_t* ds_tile = smem + L::kDsOff + (it & 1) * L::kDsTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 64 * c + 16 * warp + g + 8 * (r & 1);
          const int chunk = (2 * kk + (r >> 1)) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(ds_tile + row * 128 + chunk * 16 +
                                       4 * t4) = active ? dsa[kk][r] : 0u;
        }
      sm90::fence_proxy_async();
      // the previous item's dQ reduce has read this consumer's staging
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_bar_sync(ds_bar, ds_threads);
      // at D = 64 a consumer whose keys are unseen adds nothing to dQ
      const bool do_dq = D == 128 || active;
      if (do_dq) {
        const uint32_t ds_a = sm90::smem_addr(ds_tile) + dq_key0 * 128;
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;  // not carried
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqSteps; ++kk)  // dS read MN-major (q rows)
          sm90::wgmma_ss_n64<1, 1>(
              dq, sm90::desc_b128(ds_a + kk * 16 * 128, L::kDsTile, 1024),
              sm90::desc_b128(dq_b + kk * 16 * 128, L::kKBox, 1024), 1);
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(dsa);
      if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
      if (do_dq) {
        // scale * dQ (each tile's product scaled, :428) into the staging:
        // two [64 rows][32] f32 boxes, 128-byte swizzled; then one
        // reduce-add per box into the f32 workspace, clipped at Sq
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * warp + g + 8 * h;
            const int chunk = (2 * (j & 3) + (t4 >> 1)) ^ (row & 7);
            *reinterpret_cast<float2*>(stage + (j >> 2) * L::kDqBox +
                                       row * 128 + chunk * 16 +
                                       8 * (t4 & 1)) =
                make_float2(dq[4 * j + 2 * h] * scale,
                            dq[4 * j + 2 * h + 1] * scale);
          }
        sm90::fence_proxy_async();
        sm90::named_bar_sync(1 + c, 128);
        if (tid == 0) {
          const uint32_t src = sm90::smem_addr(stage);
          sm90::tma_reduce_add_3d(&dq_map, src, dq_col, q0, bh);
          sm90::tma_reduce_add_3d(&dq_map, src + L::kDqBox, dq_col + 32, q0,
                                  bh);
          sm90::tma_store_commit();
        }
      }
    }

    // epilogue: scale * dK and dV into this consumer's rows of the K and V
    // tiles, then TMA (clipped at Sk). At D = 128 the other consumer's last
    // dQ product reads every K row: wait for it.
    if (D == 128) sm90::named_bar_sync(3, 256);
    sm90::stage_rows<D>(smem, L::kKBox, dk, scale, c, warp, g, t4);
    sm90::stage_rows<D>(smem + L::kVOff, L::kKBox, dv, 1.f, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0) {
      if (kc0 < sk) {
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_store_3d(&dk_map, k_rows + b * L::kKBox, 64 * b, kc0,
                             bhk);
          sm90::tma_store_3d(&dv_map, v_rows + b * L::kKBox, 64 * b, kc0,
                             bhk);
        }
        sm90::tma_store_commit();
      }
      sm90::tma_store_wait();  // the stores and the dQ reduce-adds
    }
  }
}

template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_acc, void* dk,
                            void* dv, int bhk, int rep, int sq, int sk,
                            float scale, int causal, cudaStream_t stream) {
  using L = BwdWg<D>;
  const int bhq = bhk * rep;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, D, 64) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, D, 64) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, D, 128) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, D, 128) ||
      !sm90_host::map_rows_f32(&dq_map, dq_acc, bhq, sq, D, 64) ||
      !sm90_host::map_rows(&dk_map, dk, bhk, sk, D, 64) ||
      !sm90_host::map_rows(&dv_map, dv, bhk, sk, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, (sk + 127) / 128);
  flash_bwd_wgmma<D><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map,
      (const float*)lse, (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

bool valid_shape(int bh, int rep, int sq, int sk, int head_dim, int dtype) {
  return bh >= 1 && bh <= 65535 && rep >= 1 && sq >= 1 && sk >= 1 &&
         (head_dim == 64 || head_dim == 128) && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o [bhq, sq, D], k/v [bhq/rep, sk, D],
// lse [bhq, sq] f32. Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bhq, int rep, int sq, int sk,
                                          int head_dim, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  if (!valid_shape(bhq, rep, sq, sk, head_dim, dtype) || bhq % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(head_dim == 64
                     ? launch_fwd<float, 64>(q, k, v, o, lse, bhq, rep, sq,
                                             sk, scale, causal, s)
                     : launch_fwd<float, 128>(q, k, v, o, lse, bhq, rep, sq,
                                              sk, scale, causal, s));
  return (int)(head_dim == 64
                   ? launch_fwd_bf16<64>(q, k, v, o, lse, bhq, rep, sq, sk,
                                         scale, causal, s)
                   : launch_fwd_bf16<128>(q, k, v, o, lse, bhq, rep, sq, sk,
                                          scale, causal, s));
}

// dq_acc [bhk*rep, sq, D] f32 must be zero on entry; dk/dv [bhk, sk, D].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
    int bhk, int rep, int sq, int sk, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  if (!valid_shape(bhk, rep, sq, sk, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)(head_dim == 64
                     ? launch_bwd<float, 64>(q, k, v, dout, lse, delta,
                                             dq_acc, dk, dv, bhk, rep, sq, sk,
                                             scale, causal, s)
                     : launch_bwd<float, 128>(q, k, v, dout, lse, delta,
                                              dq_acc, dk, dv, bhk, rep, sq,
                                              sk, scale, causal, s));
  return (int)(head_dim == 64
                   ? launch_bwd_bf16<64>(q, k, v, dout, lse, delta, dq_acc,
                                         dk, dv, bhk, rep, sq, sk, scale,
                                         causal, s)
                   : launch_bwd_bf16<128>(q, k, v, dout, lse, delta, dq_acc,
                                          dk, dv, bhk, rep, sq, sk, scale,
                                          causal, s));
}
