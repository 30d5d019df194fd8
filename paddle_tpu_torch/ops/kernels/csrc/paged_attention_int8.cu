// Paged one-token decode attention over int8 KV pages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_int8_kernel` behind
// `paged_attention_int8` (paddle_tpu/ops/pallas/decode_attention.py:180,
// pallas_call at :267): the serving engine's int8_kv=True read path. The
// pages hold int8 codes [Hkv, num_pages, page, D] and one f32 scale per row
// [Hkv, num_pages, page, 1] (memory.quantize_rows_int8). The kernel
// computes
//
//   k = codes_k * scale_k, v = codes_v * scale_v   (in f32)
//   out[b, h*rep + r] = softmax(f32(q[b, h*rep + r]) . K_b^T * scale) . V_b
//
// over the first lengths[b] positions, never materialising a dequantized
// cache. Unlike the exact kernel, p stays in f32 for p.V (as in the
// Pallas kernel); the output is cast to q's type; l == 0 gives 0.
//
// Bound: each live row is read once, D + 4 bytes for K and again for V
// (0.516x the bytes of a bf16 row at D = 128), so the live bytes over the
// card's memory rate bound it.
//
// Design (the body is decode_body.cuh): one block of D threads per
// (sequence, kv head) walks its own pages. Each tile of 32 positions is
// staged into shared memory first: the codes with 16-byte vector loads
// (D/16 per row, consecutive threads on consecutive addresses) and the
// scales beside them; every element is then dequantized into an f32
// register as code * scale. f32 or bf16 q/out; D in {64, 128}; any page
// size; rep in 1..8.
#include "decode_body.cuh"

namespace {

using decode::kMaxRep;

template <typename T, int D>
__global__ void __launch_bounds__(D) paged_attention_int8_kernel(
    const T* __restrict__ q,                // [B, Hq, D]
    const int8_t* __restrict__ k_codes,     // [Hkv, num_pages, page, D]
    const float* __restrict__ k_scales,     // [Hkv, num_pages, page, 1]
    const int8_t* __restrict__ v_codes,
    const float* __restrict__ v_scales,
    const int* __restrict__ tables,         // [B, pages_per_seq]
    const int* __restrict__ lengths,        // [B]
    T* __restrict__ out,                    // [B, Hq, D]
    int hkv, int rep, int num_pages, int page, int pages_per_seq,
    float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const size_t head_rows = (size_t)h * num_pages * page;
  const int len = lengths[b];
  int npages = len > 0 ? (len + page - 1) / page : 0;
  if (npages > pages_per_seq) npages = pages_per_seq;
  decode::attend<T, D, true>(q, out, k_codes + head_rows * D,
                             v_codes + head_rows * D, k_scales + head_rows,
                             v_scales + head_rows,
                             tables + (size_t)b * pages_per_seq, num_pages,
                             page, npages, len, b, h, hkv * rep, rep, scale);
}

template <typename T>
void launch(const void* q, const void* kc, const void* ks, const void* vc,
            const void* vs, const int* tables, const int* lengths, void* out,
            int batch, int hkv, int rep, int head_dim, int num_pages,
            int page, int pages_per_seq, float scale, cudaStream_t stream) {
  const dim3 grid(batch, hkv);
  if (head_dim == 64) {
    paged_attention_int8_kernel<T, 64><<<grid, 64, 0, stream>>>(
        (const T*)q, (const int8_t*)kc, (const float*)ks, (const int8_t*)vc,
        (const float*)vs, tables, lengths, (T*)out, hkv, rep, num_pages,
        page, pages_per_seq, scale);
  } else {
    paged_attention_int8_kernel<T, 128><<<grid, 128, 0, stream>>>(
        (const T*)q, (const int8_t*)kc, (const float*)ks, (const int8_t*)vc,
        (const float*)vs, tables, lengths, (T*)out, hkv, rep, num_pages,
        page, pages_per_seq, scale);
  }
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. The code pointers must
// be 16-byte aligned. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* tables,
    const void* lengths, void* out, int batch, int hkv, int rep,
    int head_dim, int num_pages, int page, int pages_per_seq, float scale,
    int dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || (head_dim != 64 && head_dim != 128) ||
      page < 1 || num_pages < 1 || pages_per_seq < 1 || batch < 1 ||
      hkv < 1 || (dtype != 0 && dtype != 1) ||
      ((uintptr_t)k_codes & 15) != 0 || ((uintptr_t)v_codes & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(q, k_codes, k_scales, v_codes, v_scales,
                  (const int*)tables, (const int*)lengths, out, batch, hkv,
                  rep, head_dim, num_pages, page, pages_per_seq, scale, s);
  else
    launch<__nv_bfloat16>(q, k_codes, k_scales, v_codes, v_scales,
                          (const int*)tables, (const int*)lengths, out,
                          batch, hkv, rep, head_dim, num_pages, page,
                          pages_per_seq, scale, s);
  return (int)cudaGetLastError();
}
