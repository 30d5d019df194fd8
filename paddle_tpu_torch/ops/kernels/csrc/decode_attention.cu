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
// kernel does; l == 0 gives 0. The Pallas kernel's block_k = 512 is a TPU
// tile, not part of the function.
//
// Bound: the live KV rows' bytes over the card's memory rate. The body,
// its design and what it does about that bound are in decode_split.cuh,
// shared with paged_attention.cu: a cluster of CTAs splits each sequence's
// live rows into shares of multiples of 16 rows, each warp streams its rows
// through a cp.async ring, and the CTAs merge their partial softmaxes
// through distributed shared memory. f32, bf16 and f16; D in
// {64, 80, 96, 128, 256}; any rep.
#include "decode_split.cuh"

// A minimum of one block per SM: without it ptxas spills a few bytes in
// some instantiations to fit more blocks on an SM.
template <typename T, int D, int R>
__global__ void __launch_bounds__(decode_split::kThreads, 1)
    decode_attention_kernel(const decode_split::Params p) {
  decode_split::attend<T, T, D, R, false>(p);
}

namespace {

struct Dense {
  template <typename T>
  using Rows = T;
  template <typename T, int D, int R>
  static decode_split::KernelFn get() {
    return decode_attention_kernel<T, D, R>;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; split: CTAs per cluster
// (1..8).
// Returns the launch's CUDA error (cudaErrorInvalidValue for shapes the
// kernel does not take).
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int batch, int hkv, int rep,
    int head_dim, int seq, int split, float scale, int dtype, void* stream) {
  if (seq < 1) return (int)cudaErrorInvalidValue;
  decode_split::Params p = {};
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.lengths = (const int*)lengths;
  p.out = out;
  p.hkv = hkv;
  p.rep = rep;
  p.split = split;
  p.seq = seq;
  p.scale = scale;
  return decode_split::launch<Dense>(p, batch, head_dim, dtype,
                                     (cudaStream_t)stream);
}
