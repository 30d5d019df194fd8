// RMS norm forward for Hopper (sm_90a): a row kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` behind `rms_norm`
// (paddle_tpu/ops/pallas/rms_norm.py:25, pallas_call in `_fwd_call` at :43):
// per row o = x * rsqrt(mean(x^2) + eps) * w, the weight applied in f32 and
// the result rounded once to x's type, plus the f32 rstd. x and w are each
// f32 or bf16, in any mix; o takes x's type.
//
// Bound: each row is read once and written once with a few operations per
// element, so the bytes over the card's memory rate bound it. The design
// (a row in registers, 16-byte loads, blocks that stay on the card and
// walk the rows with the next row in flight) is norm_rows.cuh's, shared
// with add_rms_norm.cu.
#include "norm_rows.cuh"

// V chunks of E values a thread; blockDim = (tpr, 256 / tpr).
template <typename Tx, typename Tw, int V>
__global__ void __launch_bounds__(norm_rows::kThreads)
    rms_norm_kernel(const Tx* __restrict__ x, const Tw* __restrict__ w,
                    Tx* __restrict__ o, float* __restrict__ rstd, int n,
                    int h, float inv_h, float eps, int vec) {
  norm_rows::norm<Tx, void, Tw, V>(x, nullptr, w, nullptr, o, rstd, n, h,
                                   inv_h, eps, vec);
}

namespace {

template <typename Tx, typename Tw>
cudaError_t dispatch(const void* x, const void* w, void* o, void* rstd,
                     int n, int h, float eps, cudaStream_t stream) {
  constexpr int E = norm_rows::Elem<Tx>::kVec;
  const int vec = norm_rows::vectorizable<E>(h, x, w, o);
  return norm_rows::by_chunks<E>(h, [&](int tpr, auto v) {
    constexpr int V = decltype(v)::value;
    static int resident = 0;  // per instantiation, once
    return norm_rows::launch(rms_norm_kernel<Tx, Tw, V>, resident, n, tpr,
                             stream, (const Tx*)x, (const Tw*)w, (Tx*)o,
                             (float*)rstd, n, h, 1.f / (float)h, eps, vec);
  });
}

}  // namespace

// x/o [n, h] row-major, w [h], rstd [n] f32; x_dtype and w_dtype: 0 =
// float32, 1 = bfloat16. 1 <= h <= 8192. Returns the CUDA error of the
// launch (0 on success, and for n = 0; cudaErrorInvalidValue for what it
// does not take).
extern "C" int rms_norm_launch(const void* x, const void* w, void* o,
                               void* rstd, int n, int h, float eps,
                               int x_dtype, int w_dtype, void* stream) {
  if (n < 0 || h < 1 || h > norm_rows::kMaxH || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)(w_dtype == 0
                     ? dispatch<float, float>(x, w, o, rstd, n, h, eps, s)
                     : dispatch<float, __nv_bfloat16>(x, w, o, rstd, n, h,
                                                      eps, s));
  return (int)(w_dtype == 0
                   ? dispatch<__nv_bfloat16, float>(x, w, o, rstd, n, h, eps,
                                                    s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, o, rstd, n,
                                                            h, eps, s));
}
