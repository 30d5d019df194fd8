// One-token decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` behind `decode_attention`
// (paddle_tpu/ops/pallas/decode_attention.py:42, pallas_call at :105), the
// accelerator route of incubate's masked_multihead_attention:
//
//   out[b, h*rep + r] = softmax(q[b, h*rep + r] . K_b^T * scale) . V_b
//
// with q [B, Hq, D], cache [B, Hkv, S, D] and the first lengths[b] rows of
// sequence b valid. p is rounded to V's type before p.V, as the Pallas
// kernel does; l == 0 gives 0.
//
// Bound: each live KV row is read once, so the live bytes over the card's
// memory rate bound it. The Pallas kernel's block_k = 512 is a TPU tile, not
// part of the function: here the tile is 32 positions, one per lane.
//
// Design (the body is decode_body.cuh, shared with the paged kernels): one
// block of D threads per (sequence, kv head) walks one dense segment and
// stops at the sequence's length, so rows past it are never read. f32 and
// bf16; D in {64, 128}; rep in 1..8.
#include "decode_body.cuh"

namespace {

using decode::kMaxRep;

template <typename T, int D>
__global__ void __launch_bounds__(D) decode_attention_kernel(
    const T* __restrict__ q,          // [B, Hq, D]
    const T* __restrict__ k_cache,    // [B, Hkv, S, D]
    const T* __restrict__ v_cache,    // [B, Hkv, S, D]
    const int* __restrict__ lengths,  // [B]
    T* __restrict__ out,              // [B, Hq, D]
    int hkv, int rep, int seq, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t head_off = ((size_t)b * hkv + h) * seq * D;
  const int len = min(max(lengths[b], 0), seq);
  decode::attend<T, D, false>(q, out, k_cache + head_off, v_cache + head_off,
                              nullptr, nullptr, nullptr, 1, seq,
                              len > 0 ? 1 : 0, len, b, h, hkv * rep, rep,
                              scale);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* lengths,
            void* out, int batch, int hkv, int rep, int head_dim, int seq,
            float scale, cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  if (head_dim == 64) {
    decode_attention_kernel<T, 64><<<grid, 64, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, hkv, rep,
        seq, scale);
  } else {
    decode_attention_kernel<T, 128><<<grid, 128, 0, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, lengths, (T*)out, hkv, rep,
        seq, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int batch, int hkv, int rep,
    int head_dim, int seq, float scale, int dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || (head_dim != 64 && head_dim != 128) ||
      seq < 1 || batch < 1 || hkv < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(q, k_cache, v_cache, (const int*)lengths, out, batch, hkv,
                  rep, head_dim, seq, scale, s);
  else
    launch<__nv_bfloat16>(q, k_cache, v_cache, (const int*)lengths, out,
                          batch, hkv, rep, head_dim, seq, scale, s);
  return (int)cudaGetLastError();
}
