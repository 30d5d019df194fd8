// Paged one-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` behind `paged_attention`
// (paddle_tpu/ops/pallas/decode_attention.py:139, pallas_call at :336).
// It computes what that kernel computes, not a block-by-block copy of it:
//
//   out[b, h*rep + r] = softmax(q[b, h*rep + r] . K_b^T / sqrt(D)) . V_b
//
// over the first lengths[b] positions of sequence b, whose keys and values
// live in pages [Hkv, num_pages, page, D] addressed by block_tables[b, j].
//
// Bound: the kernel reads each live KV row once, so it is bound by the
// bytes of the live lengths over the card's memory rate (3.35 TB/s on an
// H100 SXM). The dot products are a few FLOPs per byte.
//
// Design:
// - One thread block per (sequence b, kv head h); its rep = Hq/Hkv q rows
//   share every K/V row it loads (GQA never materialises repeated KV). The
//   block has D threads: thread d owns output column d of all rep rows.
// - The TPU's sequential grid dimension over pages becomes a loop inside the
//   block over pages j < ceil(len/page); the block reads tables[b, j] itself
//   and clamps it to [0, num_pages-1]. Pages a sequence does not own are
//   never read; positions >= len are masked.
// - Each page is walked in tiles of 32 positions: (1) each warp takes
//   positions and reduces q.k across its lanes, (2) one warp per q row runs
//   the online-softmax update of (m, l) in f32, (3) every thread rescales
//   its accumulators and adds p.V for its column. p is rounded to V's type
//   before p.V, as the Pallas kernel does. Where l == 0 the output is 0.
// - f32 and bf16 operands; D in {64, 128}; any page size; rep in 1..8.
//   Simple first: no TMA, no wgmma and no split over pages yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;    // positions per inner step: one per lane
constexpr int kMaxRep = 8;   // q heads per kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(D) paged_attention_kernel(
    const T* __restrict__ q,          // [B, Hq, D]
    const T* __restrict__ k_pages,    // [Hkv, num_pages, page, D]
    const T* __restrict__ v_pages,    // [Hkv, num_pages, page, D]
    const int* __restrict__ tables,   // [B, pages_per_seq]
    const int* __restrict__ lengths,  // [B]
    T* __restrict__ out,              // [B, Hq, D]
    int hkv, int rep, int num_pages, int page, int pages_per_seq,
    float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kPerLane = D / 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hq = hkv * rep;

  __shared__ float q_s[kMaxRep][D];
  __shared__ float s_s[kMaxRep][kTile];  // scores, then rounded p
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float alpha_s[kMaxRep];

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

  const int len = lengths[b];
  int npages = len > 0 ? (len + page - 1) / page : 0;
  if (npages > pages_per_seq) npages = pages_per_seq;
  const size_t head_off = (size_t)h * num_pages * page * D;

  for (int j = 0; j < npages; ++j) {
    int pg = tables[(size_t)b * pages_per_seq + j];
    pg = min(max(pg, 0), num_pages - 1);
    const T* kp = k_pages + head_off + (size_t)pg * page * D;
    const T* vp = v_pages + head_off + (size_t)pg * page * D;
    for (int t0 = 0; t0 < page; t0 += kTile) {
      const int base = j * page + t0;
      if (base >= len) break;
      const int n = min(kTile, min(page - t0, len - base));

      // (1) scores s[r][i] = (q_r . k_i) * scale
      for (int i = warp; i < n; i += kWarps) {
        const T* kr = kp + (size_t)(t0 + i) * D;
        float kv[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) kv[e] = to_f32(kr[lane + 32 * e]);
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
        if (lane < n) s_s[r][lane] = to_f32(from_f32<T>(p));
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
        const float vv = to_f32(vp[(size_t)(t0 + i) * D + tid]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[r] += s_s[r][i] * vv;
      }
      __syncthreads();  // s_s and alpha_s are rewritten by the next tile
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

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* tables,
            const int* lengths, void* out, int batch, int hkv, int rep,
            int head_dim, int num_pages, int page, int pages_per_seq,
            float scale, cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  if (head_dim == 64) {
    paged_attention_kernel<T, 64><<<grid, 64, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, tables, lengths, (T*)out, hkv,
        rep, num_pages, page, pages_per_seq, scale);
  } else {
    paged_attention_kernel<T, 128><<<grid, 128, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, tables, lengths, (T*)out, hkv,
        rep, num_pages, page, pages_per_seq, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int batch, int hkv,
    int rep, int head_dim, int num_pages, int page, int pages_per_seq,
    float scale, int dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || (head_dim != 64 && head_dim != 128) ||
      page < 1 || num_pages < 1 || pages_per_seq < 1 || batch < 1 ||
      hkv < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(q, k_pages, v_pages, (const int*)tables,
                  (const int*)lengths, out, batch, hkv, rep, head_dim,
                  num_pages, page, pages_per_seq, scale, s);
  else
    launch<__nv_bfloat16>(q, k_pages, v_pages, (const int*)tables,
                          (const int*)lengths, out, batch, hkv, rep,
                          head_dim, num_pages, page, pages_per_seq, scale, s);
  return (int)cudaGetLastError();
}
