// The f32 bodies of the flash forward, the fused backward and the split
// backward's two passes (csrc/flash_attention.cu, csrc/flash_attention_split
// .cu); their bf16 routes are TMA-fed wgmma kernels. They exist for the f32
// checks, not for speed: mma.sync-shaped fragments as plain FMAs
// (warp_tile.cuh), one block of 4 warps (16 rows each) per 64-row tile.
//
// Every head width d <= 256 (a multiple of 4, so rows are 16-byte vectors)
// runs on a padded width DP of 64, 128, 192 or 256 columns; columns at or
// past d load as zero (they add nothing to q k^T, and give zero columns of
// o, dq, dk and dv) and are never stored. A block owns one 64-column chunk
// `cc` of its outputs (grid z = DP / 64), so its accumulators are 64
// columns wide at any d: the scores S = q k^T and dP = dO v^T, which need
// every column, are summed chunk by chunk in each block.
// - forward: q tile resident at full width, each k tile's K chunks stream
//   through one chunk buffer, V's chunk cc beside it; o[:, cc] = P V[:, cc]
//   with the online softmax (every chunk's block computes the same m, l; the
//   one with cc = 0 writes lse).
// - dk/dv (and, fused, dq): K and V tiles resident at full width; Q and dO
//   chunks stream, in the order cc + 1, ..., cc, so the last pair in the
//   buffers is chunk cc: dV[:, cc] += P^T dO[:, cc], dK[:, cc] += dS^T
//   Q[:, cc] and, fused, dq[:, cc] += scale * dS K[:, cc] by f32 atomicAdd
//   into the zeroed workspace. dK is scaled once, at the store.
// - dq: Q and dO tiles resident, K and V chunks stream (chunk cc last);
//   dq[:, cc] += scale * dS K[:, cc], each tile's product scaled before it
//   joins the sum (the Pallas kernel's :307); dq is written once.
#pragma once

#include "warp_tile.cuh"

namespace flash_f32 {

using ptk::warp_mma;

constexpr int kBQ = 64;        // q rows per tile
constexpr int kBK = 64;        // k rows per tile
constexpr int kC = 64;         // columns per chunk
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLdc = kC + 8;   // chunk rows, padded (bank spread)
constexpr float kNegInf = -1e30f;

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

// Columns [col0, col0 + NC) of rows [0, rows) of a row-major [*, d] f32
// tile into shared memory with row stride ld, 16 bytes per thread and step;
// zero at rows >= valid and columns >= d.
template <int NC>
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src,
                                          int d, int col0, int rows,
                                          int valid, int tid) {
  constexpr int kPerRow = NC / 4;
  for (int i = tid; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && col0 + c < d)
      val = *reinterpret_cast<const float4*>(src + (size_t)r * d + col0 + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// A 16-row warp accumulator (rows r0 + g, r0 + g + 8; 64 columns of chunk
// col0) into a row-major [*, d] tensor, rows below `rows` and columns below
// d only, each value times `mul`.
__device__ __forceinline__ void store_chunk(float* dst, const float (*acc)[4],
                                            int r0, int rows, int d, int col0,
                                            float mul, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;  // d is even: both or neither
      if (col >= d) continue;
      dst[(size_t)row * d + col] = acc[j][2 * h] * mul;
      dst[(size_t)row * d + col + 1] = acc[j][2 * h + 1] * mul;
    }
  }
}

template <int DP>
struct FwdSmem {
  static constexpr int kLdq = DP + 8;
  static constexpr size_t kBytes =
      (size_t)(kBQ * kLdq + 3 * kBK * kLdc) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int rep, int sq, int sk, int d,
               float scale, int causal) {
  using L = FwdSmem<DP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBQ * L::kLdq;
  float* vs = ks + kBK * kLdc;
  float* ps = vs + kBK * kLdc;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ, cc = blockIdx.z * kC;
  const int offset = sk - sq;
  const float* qp = q + (size_t)bh * sq * d;
  const float* kp = k + (size_t)(bh / rep) * sk * d;
  const float* vp = v + (size_t)(bh / rep) * sk * d;

  load_cols<DP>(qs, L::kLdq, qp + (size_t)q0 * d, d, 0, kBQ,
                min(kBQ, sq - q0), tid);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kC / 8][4];
  ptk::zero<kC / 8>(acc);

  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + kBQ, sq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kv = min(kBK, sk - k0);
    float s[kBK / 8][4];
    ptk::zero<kBK / 8>(s);
#pragma unroll 1
    for (int ch = 0; ch < DP; ch += kC) {
      __syncthreads();  // every warp is done with the chunk buffers
      load_cols<kC>(ks, kLdc, kp + (size_t)k0 * d, d, ch, kBK, kv, tid);
      if (ch == 0)
        load_cols<kC>(vs, kLdc, vp + (size_t)k0 * d, d, cc, kBK, kv, tid);
      __syncthreads();
      warp_mma<float, kBK / 8>(s, qs + warp * 16 * L::kLdq + ch, L::kLdq, 1,
                               ks, kLdc, 1, kC, lane);
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float x = visible(rows[e >> 1], col, sq, sk, offset, causal)
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
    for (int j = 0; j < kC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // P through the warp's own rows of shared memory as the A operand
    float* prow = ps + (warp * 16 + g) * kLdc;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        prow[(e >> 1) * 8 * kLdc + 8 * j + 2 * t + (e & 1)] = s[j][e];
    __syncwarp();
    warp_mma<float, kC / 8>(acc, ps + warp * 16 * kLdc, kLdc, 1, vs, 1, kLdc,
                            kBK, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float ls = l[h] == 0.f ? 1.f : l[h];
    inv[h] = 1.f / ls;
    if (cc == 0 && t == 0 && rows[h] < sq)
      lse[(size_t)bh * sq + rows[h]] = m[h] + logf(ls);
  }
#pragma unroll
  for (int j = 0; j < kC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  store_chunk(o + (size_t)bh * sq * d, acc, q0 + warp * 16, sq, d, cc, 1.f,
              g, t);
}

template <int DP>
struct KvSmem {
  static constexpr int kLdk = DP + 8;
  static constexpr size_t kBytes =
      (size_t)(2 * kBK * kLdk + 4 * kBQ * kLdc) * sizeof(float) +
      2 * kBQ * sizeof(float);
};

// dk, dv (and, with KDQ, scale * dS K added into the zeroed dq_acc) of one
// 64-key tile and 64-column chunk.
template <int DP, bool KDQ>
__global__ void __launch_bounds__(kThreads)
    bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq_acc,
                  float* __restrict__ dk, float* __restrict__ dv, int rep,
                  int sq, int sk, int d, float scale, int causal) {
  using L = KvSmem<DP>;
  constexpr int kChunks = DP / kC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kBK * L::kLdk;
  float* qs = vs + kBK * L::kLdk;
  float* dos = qs + kBQ * kLdc;
  float* ps = dos + kBQ * kLdc;
  float* dss = ps + kBQ * kLdc;
  float* lse_s = dss + kBQ * kLdc;
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y, k0 = blockIdx.x * kBK, cz = blockIdx.z;
  const int cc = cz * kC;
  const int offset = sk - sq;
  const size_t kv_base = (size_t)bhk * sk * d;
  const int kv = min(kBK, sk - k0);

  load_cols<DP>(ks, L::kLdk, k + kv_base + (size_t)k0 * d, d, 0, kBK, kv,
                tid);
  load_cols<DP>(vs, L::kLdk, v + kv_base + (size_t)k0 * d, d, 0, kBK, kv,
                tid);

  float dk_acc[kC / 8][4], dv_acc[kC / 8][4];
  ptk::zero<kC / 8>(dk_acc);
  ptk::zero<kC / 8>(dv_acc);

  // the first q tile with a row that sees key k0 (causal clamp)
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / kBQ * kBQ;
  const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};

  for (int r = 0; r < rep; ++r) {
    const int bh = bhk * rep + r;
    const float* qp = q + (size_t)bh * sq * d;
    const float* dop = dout + (size_t)bh * sq * d;
    for (int q0 = q_begin; q0 < sq; q0 += kBQ) {
      const int qv = min(kBQ, sq - q0);
      float s[kBK / 8][4], dp[kBK / 8][4];
      ptk::zero<kBK / 8>(s);
      ptk::zero<kBK / 8>(dp);
#pragma unroll 1
      for (int i = 1; i <= kChunks; ++i) {  // chunk cc last
        const int ch = (cz + i) % kChunks * kC;
        __syncthreads();  // every warp is done with the previous tiles
        load_cols<kC>(qs, kLdc, qp + (size_t)q0 * d, d, ch, kBQ, qv, tid);
        load_cols<kC>(dos, kLdc, dop + (size_t)q0 * d, d, ch, kBQ, qv, tid);
        if (i == 1)
          for (int j = tid; j < kBQ; j += kThreads) {
            lse_s[j] = j < qv ? lse[(size_t)bh * sq + q0 + j] : 0.f;
            delta_s[j] = j < qv ? delta[(size_t)bh * sq + q0 + j] : 0.f;
          }
        __syncthreads();
        // this warp's 16 q rows against the block's 64 keys
        warp_mma<float, kBK / 8>(s, qs + warp * 16 * kLdc, kLdc, 1, ks + ch,
                                 L::kLdk, 1, kC, lane);
        warp_mma<float, kBK / 8>(dp, dos + warp * 16 * kLdc, kLdc, 1,
                                 vs + ch, L::kLdk, 1, kC, lane);
      }
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
          ps[lrow[h] * kLdc + col] = p;
          dss[lrow[h] * kLdc + col] = p * (dp[j][e] - del_r[h]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for this warp's 16 keys, chunk cc
      warp_mma<float, kC / 8>(dv_acc, ps + warp * 16, 1, kLdc, dos, 1, kLdc,
                              kBQ, lane);
      warp_mma<float, kC / 8>(dk_acc, dss + warp * 16, 1, kLdc, qs, 1, kLdc,
                              kBQ, lane);
      if constexpr (KDQ) {
        // dQ[:, cc] += scale * dS K[:, cc] for this warp's 16 q rows, 32
        // columns at a time
        float* dqp = dq_acc + (size_t)bh * sq * d;
#pragma unroll
        for (int c0 = 0; c0 < kC; c0 += 32) {
          float part[4][4];
          ptk::zero<4>(part);
          warp_mma<float, 4>(part, dss + warp * 16 * kLdc, kLdc, 1,
                             ks + cc + c0, 1, L::kLdk, kBK, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = q0 + lrow[h];
            if (row >= sq) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = cc + c0 + 8 * j + 2 * t;
              if (col >= d) continue;
              atomicAdd(dqp + (size_t)row * d + col, scale * part[j][2 * h]);
              atomicAdd(dqp + (size_t)row * d + col + 1,
                        scale * part[j][2 * h + 1]);
            }
          }
        }
      }
    }
  }

  store_chunk(dk + kv_base, dk_acc, k0 + warp * 16, sk, d, cc, scale, g, t);
  store_chunk(dv + kv_base, dv_acc, k0 + warp * 16, sk, d, cc, 1.f, g, t);
}

template <int DP>
struct DqSmem {
  static constexpr int kLdq = DP + 8;
  static constexpr size_t kBytes =
      (size_t)(2 * kBQ * kLdq + 3 * kBK * kLdc) * sizeof(float);
};

// acc += scale * (A(16 x 64) . B(64 x 64)), 32 output columns at a time:
// each tile's product is scaled in f32 before it joins the sum.
__device__ __forceinline__ void add_scaled(float (*acc)[4], const float* A,
                                           int ar, const float* B, int bk,
                                           float scale, int lane) {
#pragma unroll
  for (int c0 = 0; c0 < kC; c0 += 32) {
    float part[4][4];
    ptk::zero<4>(part);
    warp_mma<float, 4>(part, A, ar, 1, B + c0, 1, bk, kBK, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 / 8 + j][e] += scale * part[j][e];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int rep, int sq, int sk, int d,
              float scale, int causal) {
  using L = DqSmem<DP>;
  constexpr int kChunks = DP / kC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kBQ * L::kLdq;
  float* ks = dos + kBQ * L::kLdq;
  float* vs = ks + kBK * kLdc;
  float* dss = vs + kBK * kLdc;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ, cz = blockIdx.z;
  const int offset = sk - sq;
  const size_t q_base = (size_t)bh * sq * d;
  const float* kp = k + (size_t)(bh / rep) * sk * d;
  const float* vp = v + (size_t)(bh / rep) * sk * d;

  const int qv = min(kBQ, sq - q0);
  load_cols<DP>(qs, L::kLdq, q + q_base + (size_t)q0 * d, d, 0, kBQ, qv,
                tid);
  load_cols<DP>(dos, L::kLdq, dout + q_base + (size_t)q0 * d, d, 0, kBQ, qv,
                tid);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < sq;
    lse_r[h] = in ? lse[(size_t)bh * sq + rows[h]] : 0.f;
    del_r[h] = in ? delta[(size_t)bh * sq + rows[h]] : 0.f;
  }
  float acc[kC / 8][4];
  ptk::zero<kC / 8>(acc);
  float* ds_rows = dss + warp * 16 * kLdc;  // this warp's 16 rows of dS

  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + kBQ, sq) + offset);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kv = min(kBK, sk - k0);
    float s[kBK / 8][4], dp[kBK / 8][4];
    ptk::zero<kBK / 8>(s);
    ptk::zero<kBK / 8>(dp);
#pragma unroll 1
    for (int i = 1; i <= kChunks; ++i) {  // chunk cc last
      const int ch = (cz + i) % kChunks * kC;
      __syncthreads();  // every warp is done with the previous K, V chunks
      load_cols<kC>(ks, kLdc, kp + (size_t)k0 * d, d, ch, kBK, kv, tid);
      load_cols<kC>(vs, kLdc, vp + (size_t)k0 * d, d, ch, kBK, kv, tid);
      __syncthreads();
      warp_mma<float, kBK / 8>(s, qs + warp * 16 * L::kLdq + ch, L::kLdq, 1,
                               ks, kLdc, 1, kC, lane);
      warp_mma<float, kBK / 8>(dp, dos + warp * 16 * L::kLdq + ch, L::kLdq,
                               1, vs, kLdc, 1, kC, lane);
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = visible(rows[h], k0 + col, sq, sk, offset, causal)
                            ? expf(s[j][e] * scale - lse_r[h])
                            : 0.f;
        ds_rows[(g + 8 * h) * kLdc + col] = p * (dp[j][e] - del_r[h]);
      }
    __syncwarp();
    // dq[:, cc] += scale * dS K[:, cc] for this warp's 16 rows
    add_scaled(acc, ds_rows, kLdc, ks, kLdc, scale, lane);
  }
  store_chunk(dq + q_base, acc, q0 + warp * 16, sq, d, cz * kC, 1.f, g, t);
}

// ------------------------------------------------------------- launchers
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bhq, int rep, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t stream) {
  const size_t smem = FwdSmem<DP>::kBytes;
  cudaError_t err = set_smem(fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq, DP / kC);
  fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, rep, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <int DP, bool KDQ>
cudaError_t launch_bwd_kv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq_acc, void* dk, void* dv,
                          int bhk, int rep, int sq, int sk, int d, float scale,
                          int causal, cudaStream_t stream) {
  const size_t smem = KvSmem<DP>::kBytes;
  cudaError_t err = set_smem(bwd_kv_kernel<DP, KDQ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kBK - 1) / kBK, bhk, DP / kC);
  bwd_kv_kernel<DP, KDQ><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq_acc, (float*)dk,
      (float*)dv, rep, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bhq, int rep, int sq, int sk, int d,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = DqSmem<DP>::kBytes;
  cudaError_t err = set_smem(dq_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq, DP / kC);
  dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, rep, sq, sk, d,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_f32

// The padded width of a head width d <= 256: 64, 128, 192 or 256 columns.
inline int padded_width(int d) { return (d + 63) / 64 * 64; }

// Calls fn(std::integral_constant<int, DP>{}) for d's padded width.
template <typename F>
cudaError_t by_width(int d, F fn) {
  switch (padded_width(d)) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

// Shapes the four flash entry points take: d <= 256 with rows of whole
// 16-byte vectors (dtype 0 = float32, 1 = bfloat16).
inline bool flash_shape_ok(int bh, int rep, int sq, int sk, int d,
                           int dtype) {
  const int align = dtype == 0 ? 4 : 8;
  return bh >= 1 && bh <= 65535 && rep >= 1 && sq >= 1 && sk >= 1 &&
         d >= 1 && d <= 256 && d % align == 0 && (dtype == 0 || dtype == 1);
}
