// decode_body.cuh: the body of the int8 one-token decode attention kernel
// for Hopper (sm_90a), paged_attention_int8.cu (int8 pages, dequantized in
// the kernel). Only that kernel uses it now: the exact paged and dense
// kernels moved to the split-sequence body of decode_split.cuh. It keeps
// the first port's design, described below, and its exact-row branch.
//
//   out[b, h*rep + r] = softmax(q[b, h*rep + r] . K_b^T * scale) . V_b
//
// over the first len positions of sequence b.
//
// Bound: each live KV row is read once, a few FLOPs per byte, so the bytes
// of the live rows over the card's memory rate bound every variant.
//
// Design:
// - One thread block of D threads per (sequence b, kv head h); its
//   rep = Hq/Hkv q rows share every K/V row it loads (GQA never
//   materialises repeated KV). Thread d owns output column d of all rep
//   rows.
// - The TPU kernels' sequential grid dimension over pages or blocks becomes
//   a loop inside the block over segments of seg_len rows (a page found
//   through the block table, or the whole dense cache), each walked in
//   tiles of 32 positions; positions >= len are never read. Per tile:
//   (1) each warp takes positions and reduces q.k across its lanes, (2) one
//   warp per q row runs the online-softmax update of (m, l) in f32, (3)
//   every thread rescales its accumulators and adds p.V for its column.
//   Where l == 0 the output is 0.
// - Exact rows (f32 or bf16) are read straight from device memory and p
//   is rounded to V's type before p.V, as the exact Pallas kernels do.
//   Int8 rows (kInt8) are staged per tile into shared memory: the codes
//   with 16-byte vector loads (D/16 per row, consecutive threads on
//   consecutive addresses), one f32 scale per row beside them; an element
//   is code * scale in f32 and p stays in f32, as the int8 Pallas kernel
//   computes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int kTile = 32;    // positions per inner step: one per lane
constexpr int kMaxRep = 8;   // q heads per kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's whole computation for (b, h). q and out are [B, Hq, D] of T.
// k_head / v_head point at this kv head's rows (T, or int8 codes when
// kInt8, with ks_head / vs_head at their f32 scales); row r of segment j
// is row (table ? clamp(table[j]) * seg_len : 0) + r.
template <typename T, int D, bool kInt8>
__device__ __forceinline__ void attend(
    const T* __restrict__ q, T* __restrict__ out,
    const typename std::conditional<kInt8, int8_t, T>::type* __restrict__
        k_head,
    const typename std::conditional<kInt8, int8_t, T>::type* __restrict__
        v_head,
    const float* __restrict__ ks_head, const float* __restrict__ vs_head,
    const int* __restrict__ table, int num_pages, int seg_len, int nseg,
    int len, int b, int h, int hq, int rep, float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kPerLane = D / 32;
  constexpr int kStage = kInt8 ? kTile * D : 16;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float s_s[kMaxRep][kTile];  // scores, then p
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float alpha_s[kMaxRep];
  __shared__ __align__(16) int8_t kc_s[kStage];  // staged int8 tile
  __shared__ __align__(16) int8_t vc_s[kStage];
  __shared__ float ks_s[kTile];
  __shared__ float vs_s[kTile];

  for (int r = 0; r < rep; ++r)
    q_s[r][tid] = to_f32(q[((size_t)b * hq + h * rep + r) * D + tid]);
  if (tid < kMaxRep) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int j = 0; j < nseg; ++j) {
    size_t row0 = 0;
    if (table != nullptr)
      row0 = (size_t)min(max(table[j], 0), num_pages - 1) * seg_len;
    const auto* kp = k_head + row0 * D;
    const auto* vp = v_head + row0 * D;
    for (int t0 = 0; t0 < seg_len; t0 += kTile) {
      const int base = j * seg_len + t0;
      if (base >= len) break;
      const int n = min(kTile, min(seg_len - t0, len - base));

      if constexpr (kInt8) {
        const int4* ksrc = reinterpret_cast<const int4*>(kp + (size_t)t0 * D);
        const int4* vsrc = reinterpret_cast<const int4*>(vp + (size_t)t0 * D);
        for (int c = tid; c < n * (D / 16); c += D) {
          reinterpret_cast<int4*>(kc_s)[c] = ksrc[c];
          reinterpret_cast<int4*>(vc_s)[c] = vsrc[c];
        }
        if (tid < n) {
          ks_s[tid] = ks_head[row0 + t0 + tid];
          vs_s[tid] = vs_head[row0 + t0 + tid];
        }
        __syncthreads();
      }

      // (1) scores s[r][i] = (q_r . k_i) * scale
      for (int i = warp; i < n; i += kWarps) {
        float kv[kPerLane];
        if constexpr (kInt8) {
#pragma unroll
          for (int e = 0; e < kPerLane; ++e)
            kv[e] = to_f32(kc_s[i * D + lane + 32 * e]) * ks_s[i];
        } else {
          const auto* kr = kp + (size_t)(t0 + i) * D;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) kv[e] = to_f32(kr[lane + 32 * e]);
        }
        for (int r = 0; r < rep; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e)
            part += q_s[r][lane + 32 * e] * kv[e];
          part = warp_sum(part);
          if (lane == 0) s_s[r][i] = part * scale;
        }
      }
      __syncthreads();

      // (2) online softmax, one warp per q row
      for (int r = warp; r < rep; r += kWarps) {
        const float s = lane < n ? s_s[r][lane] : -1e30f;
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = lane < n ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_prev - m_new);
        const float psum = warp_sum(p);
        if (lane < n) s_s[r][lane] = kInt8 ? p : to_f32(from_f32<T>(p));
        if (lane == 0) {
          l_s[r] = alpha * l_s[r] + psum;
          m_s[r] = m_new;
          alpha_s[r] = alpha;
        }
      }
      __syncthreads();

      // (3) acc[r] = acc[r] * alpha[r] + sum_i p[r][i] * v[i][d]
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] *= alpha_s[r];
      for (int i = 0; i < n; ++i) {
        float vv;
        if constexpr (kInt8)
          vv = to_f32(vc_s[i * D + tid]) * vs_s[i];
        else
          vv = to_f32(vp[(size_t)(t0 + i) * D + tid]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[r] += s_s[r][i] * vv;
      }
      __syncthreads();  // the next tile rewrites s, alpha and staged rows
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const float l = l_s[r];
      out[((size_t)b * hq + h * rep + r) * D + tid] =
          from_f32<T>(acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}

}  // namespace decode
