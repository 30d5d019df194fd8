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
// Design: the split-sequence body of decode_split.cuh, shared with the
// exact paged_attention.cu and decode_attention.cu. A cluster of CTAs
// splits each sequence into whole-page shares; each warp streams its rows'
// codes through a cp.async ring in 16-byte copies, with each row's two f32
// scales beside them; a lane turns 8 codes at a time into f32 by byte
// permutes (no I2F) and keeps the scales out of the inner products; the
// CTAs merge their partial softmaxes through distributed shared memory in a
// fixed order. f32, bf16 or f16 q/out; D in {64, 80, 96, 128, 256}; any page
// size; any rep.
#include "decode_split.cuh"

// A minimum of one block per SM, as for the exact kernels: without it
// ptxas may spill to fit more blocks on an SM.
template <typename T, int D, int R>
__global__ void __launch_bounds__(decode_split::kThreads, 1)
    paged_attention_int8_kernel(const decode_split::Params p) {
  decode_split::attend<T, int8_t, D, R, true>(p);
}

namespace {

struct PagedInt8 {
  template <typename T>
  using Rows = int8_t;
  template <typename T, int D, int R>
  static decode_split::KernelFn get() {
    return paged_attention_int8_kernel<T, D, R>;
  }
};

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16, 2 = float16; split:
// CTAs per cluster (1..8). The code pointers must be 16-byte aligned.
// Returns the launch's CUDA error (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int paged_attention_int8_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* tables,
    const void* lengths, void* out, int batch, int hkv, int rep,
    int head_dim, int num_pages, int page, int pages_per_seq, int split,
    float scale, int dtype, void* stream) {
  if (page < 1 || num_pages < 1 || pages_per_seq < 1 ||
      ((uintptr_t)k_codes & 15) != 0 || ((uintptr_t)v_codes & 15) != 0)
    return (int)cudaErrorInvalidValue;
  decode_split::Params p = {};
  p.q = q;
  p.k = k_codes;
  p.v = v_codes;
  p.k_scales = (const float*)k_scales;
  p.v_scales = (const float*)v_scales;
  p.tables = (const int*)tables;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.hkv = hkv;
  p.rep = rep;
  p.split = split;
  p.num_pages = num_pages;
  p.page = page;
  p.pages_per_seq = pages_per_seq;
  p.head_stride = num_pages * page;  // head-major [Hkv, num_pages, page, D]
  p.page_stride = page;
  p.scale = scale;
  return decode_split::launch<PagedInt8>(p, batch, head_dim, dtype,
                                         (cudaStream_t)stream);
}
