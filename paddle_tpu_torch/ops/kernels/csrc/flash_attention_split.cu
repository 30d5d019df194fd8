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
// (:356); the scale multiplies each tile's f32 product before it joins the
// sum (:307, :355).
//
// Bound: at the long-context shape (S = 32768, D = 128, causal) the dq pass
// does 6 * D multiply-add operations per visible (query, key) pair
// (S = QK^T, dP = dO V^T, dS K) and the dk/dv pass 8 * D (the same two
// products, P^T dO and dS^T Q), against 4 * S * D * 2 bytes per head; both
// sit far above the card's ~295 FLOP/byte ridge, so the bf16 tensor-core
// rate bounds them.
//
// Design (simple first; no TMA, no wgmma, no pipelining yet):
// - dq: one block of 4 warps per (q head, 64-row q tile), in place of the
//   TPU's sequential third grid dimension over k tiles. Q and dO are loaded
//   once; the block walks the k tiles up to the causal diagonal (tiles
//   wholly above it are skipped, as the `pl.when` at :312 does). Per tile
//   each warp forms S = Q K^T and dP = dO V^T for its 16 rows on mma.sync
//   m16n8k16, P and dS in registers, stages dS (rounded) in its own rows of
//   shared memory and adds scale * dS K to a 16 x D f32 accumulator in
//   registers. dq is written once.
// - dk/dv: one block per (kv head, 64-row k tile), the fused kernel of
//   csrc/flash_attention.cu without its dq atomics: dK and dV accumulate
//   in f32 registers while the block walks the rep q heads and their q
//   tiles from the causal clamp (`_clamp_qi` :227).
// - Every output element is written by one thread after a loop in a fixed
//   order, so two runs give the same bits.
// - f32 operands run the same fragments with plain FMAs, for the checks.
// - D in {64, 128}; any Sq, Sk (the ragged last tile is masked).
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
                   ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                  dq, bhq, rep, sq, sk, scale,
                                                  causal, s)
                   : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta,
                                                   dq, bhq, rep, sq, sk,
                                                   scale, causal, s));
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
                   ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                   dk, dv, bhk, rep, sq, sk,
                                                   scale, causal, s)
                   : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse,
                                                    delta, dk, dv, bhk, rep,
                                                    sq, sk, scale, causal,
                                                    s));
}
