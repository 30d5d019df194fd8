// Fused residual add + RMS norm forward for Hopper (sm_90a): a row kernel.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`/`_fwd` behind `add_rms_norm`
// (paddle_tpu/ops/pallas/add_rms_norm.py:32, pallas_call at :48): per row
// y = x + r, added in f32 and rounded to x's type (the new residual
// stream), then o = y * rsqrt(mean(y^2) + eps) * w from the ROUNDED y, the
// weight applied in f32 and the result rounded once, plus the f32 rstd.
// x, r and w are each f32 or bf16, in any mix; y and o take x's type.
//
// Bound: x and r are read once and y and o written once, a few operations
// per element, so the bytes over the card's memory rate bound it. The
// design is norm_rows.cuh's, shared with rms_norm.cu: a row in registers
// over 32 to 256 threads with 16-byte loads, so x, r, y and o each cross
// device memory once; blocks that stay on the card and walk the rows,
// reading the weight once each, with the next row (x and r) in flight.
#include "norm_rows.cuh"

// V chunks of E values a thread; blockDim = (tpr, 256 / tpr).
template <typename Tx, typename Tr, typename Tw, int V>
__global__ void __launch_bounds__(norm_rows::kThreads)
    add_rms_norm_kernel(const Tx* __restrict__ x, const Tr* __restrict__ r,
                        const Tw* __restrict__ w, Tx* __restrict__ y,
                        Tx* __restrict__ o, float* __restrict__ rstd, int n,
                        int h, float inv_h, float eps, int vec) {
  norm_rows::norm<Tx, Tr, Tw, V>(x, r, w, y, o, rstd, n, h, inv_h, eps, vec);
}

namespace {

struct Args {
  const void *x, *r, *w;
  void *y, *o, *rstd;
  int n, h;
  float eps;
  cudaStream_t stream;
};

template <typename Tx, typename Tr, typename Tw>
cudaError_t dispatch(const Args& a) {
  constexpr int E = norm_rows::Elem<Tx>::kVec;
  const int vec = norm_rows::vectorizable<E>(a.h, a.x, a.r, a.w, a.y, a.o);
  return norm_rows::by_chunks<E>(a.h, [&](int tpr, auto v) {
    constexpr int V = decltype(v)::value;
    static int resident = 0;  // per instantiation, once
    return norm_rows::launch(add_rms_norm_kernel<Tx, Tr, Tw, V>, resident,
                             a.n, tpr, a.stream, (const Tx*)a.x,
                             (const Tr*)a.r, (const Tw*)a.w, (Tx*)a.y,
                             (Tx*)a.o, (float*)a.rstd, a.n, a.h,
                             1.f / (float)a.h, a.eps, vec);
  });
}

template <typename Tx, typename Tr>
cudaError_t by_weight(const Args& a, int w_dtype) {
  return w_dtype == 0 ? dispatch<Tx, Tr, float>(a)
                      : dispatch<Tx, Tr, __nv_bfloat16>(a);
}

template <typename Tx>
cudaError_t by_residual(const Args& a, int r_dtype, int w_dtype) {
  return r_dtype == 0 ? by_weight<Tx, float>(a, w_dtype)
                      : by_weight<Tx, __nv_bfloat16>(a, w_dtype);
}

}  // namespace

// x, r, y, o [n, h] row-major, w [h], rstd [n] f32; x_dtype, r_dtype and
// w_dtype: 0 = float32, 1 = bfloat16 (y and o take x's). 1 <= h <= 8192.
// Returns the CUDA error of the launch (0 on success, and for n = 0;
// cudaErrorInvalidValue for what it does not take).
extern "C" int add_rms_norm_launch(const void* x, const void* r,
                                   const void* w, void* y, void* o,
                                   void* rstd, int n, int h, float eps,
                                   int x_dtype, int r_dtype, int w_dtype,
                                   void* stream) {
  if (n < 0 || h < 1 || h > norm_rows::kMaxH || x_dtype < 0 || x_dtype > 1 ||
      r_dtype < 0 || r_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Args a = {x, r, w, y, o, rstd, n, h, eps, (cudaStream_t)stream};
  return (int)(x_dtype == 0
                   ? by_residual<float>(a, r_dtype, w_dtype)
                   : by_residual<__nv_bfloat16>(a, r_dtype, w_dtype));
}
