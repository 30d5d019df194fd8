// Paged one-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` behind `paged_attention`
// (paddle_tpu/ops/pallas/decode_attention.py:139, pallas_call at :336):
//
//   out[b, h*rep + r] = softmax(q[b, h*rep + r] . K_b^T * scale) . V_b
//
// over the first lengths[b] positions of sequence b, whose keys and values
// live in pages [Hkv, num_pages, page, D] addressed by block_tables[b, j]
// (clamped to [0, num_pages - 1]); p is rounded to V's type before p.V.
//
// Bound: the live KV rows' bytes over the card's memory rate. The body,
// its design and what it does about that bound are in decode_split.cuh,
// shared with the dense decode_attention.cu: a cluster of CTAs splits each
// sequence into whole-page shares, each warp streams its rows through a
// cp.async ring, and the CTAs merge their partial softmaxes through
// distributed shared memory. f32 and bf16; D in {64, 80, 96, 128, 256};
// any page size; any rep.
#include "decode_split.cuh"

// A minimum of one block per SM: without it ptxas spills a few bytes in
// some instantiations to fit more blocks on an SM.
template <typename T, int D, int R>
__global__ void __launch_bounds__(decode_split::kThreads, 1)
    paged_attention_kernel(const decode_split::Params p) {
  decode_split::attend<T, T, D, R, true>(p);
}

namespace {

struct Paged {
  template <typename T>
  using Rows = T;
  template <typename T, int D, int R>
  static decode_split::KernelFn get() {
    return paged_attention_kernel<T, D, R>;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; split: CTAs per cluster (1..8).
// Returns the launch's CUDA error (cudaErrorInvalidValue for shapes the
// kernel does not take).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int batch, int hkv,
    int rep, int head_dim, int num_pages, int page, int pages_per_seq,
    int split, float scale, int dtype, void* stream) {
  if (page < 1 || num_pages < 1 || pages_per_seq < 1)
    return (int)cudaErrorInvalidValue;
  decode_split::Params p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.tables = (const int*)tables;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.hkv = hkv;
  p.rep = rep;
  p.split = split;
  p.num_pages = num_pages;
  p.page = page;
  p.pages_per_seq = pages_per_seq;
  p.scale = scale;
  return decode_split::launch<Paged>(p, batch, head_dim, dtype,
                                     (cudaStream_t)stream);
}
