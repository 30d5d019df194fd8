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
// Design (simple first; no TMA, no wgmma, no pipelining yet):
// - Forward: one block of 4 warps per (bh, 64-row q tile). The TPU's
//   sequential third grid dimension over k tiles becomes a loop inside the
//   block; tiles wholly above the causal diagonal are never visited (the
//   `pl.when` at :149). Q, K, V tiles sit in shared memory; each warp owns
//   16 q rows. S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); the online softmax (m, l) and O live in f32
//   registers. p is rounded to v's type before P V (:141). Masked
//   positions carry the JAX package's NEG_INF = -1e30 in the max and
//   contribute p = 0; a row that sees no key gets o = 0 and lse = m
//   (the l == 0 guards of :157-161).
// - Backward: one block per (b * Hkv, 64-row k tile). dK and dV of the
//   tile accumulate in f32 registers while the block walks the rep q heads
//   of its kv head and their q tiles at or below the diagonal (`_clamp_qi`
//   :227). Per q tile it forms S and P = exp(S*scale - lse), dP = dO V^T
//   and dS = P (dP - delta) in registers, stages P (rounded to do's type,
//   :415) and dS (rounded to q's type, :422) in shared memory, and adds
//   P^T dO to dV and dS^T Q to dK. On the TPU dq accumulated across k tiles
//   in VMEM scratch, which its sequential grid allows; here blocks run in
//   no order, so scale * dS K goes by f32 atomicAdd into a zeroed
//   [B*Hq, Sq, D] f32 workspace that the caller casts to q's type. The
//   order of those sums changes from run to run.
// - f32 operands run the same fragments with plain FMAs, for the checks.
// - D in {64, 128}; any Sq, Sk (the ragged last tile is masked).
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
                   ? launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, bhq, rep,
                                                   sq, sk, scale, causal, s)
                   : launch_fwd<__nv_bfloat16, 128>(q, k, v, o, lse, bhq,
                                                    rep, sq, sk, scale,
                                                    causal, s));
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
                   ? launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, lse, delta,
                                                   dq_acc, dk, dv, bhk, rep,
                                                   sq, sk, scale, causal, s)
                   : launch_bwd<__nv_bfloat16, 128>(
                         q, k, v, dout, lse, delta, dq_acc, dk, dv, bhk, rep,
                         sq, sk, scale, causal, s));
}
