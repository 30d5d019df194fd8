// Hopper (sm_90a) building blocks shared by the TMA-fed wgmma kernels
// (swiglu_down, the flash-attention forward, the fused and split flash
// backward): mbarriers, TMA tensor loads, stores and reduce-adds, the
// shared-memory matrix descriptor of 128-byte-swizzled bf16 tiles, wgmma
// (SS and RS forms, bf16 or f16 in, f32 accumulate) with its fence/commit/wait,
// setmaxnreg, the attention backward's tile helpers, and the host-side
// tensor-map encoder.
//
// Conventions:
// - Every tile in shared memory is 1024-byte aligned and was written by
//   TMA with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 bf16 or f16 (128 bytes), the
//   16-byte chunk c of row r stored at chunk c ^ (r % 8). A tile wider than
//   64 columns is several such boxes, one after another.
// - K-major operand (k contiguous): descriptor SBO = 1024 (the next 8
//   rows); a k16 step inside the 64-wide box adds 32 bytes to the start.
// - MN-major operand (n contiguous, "transposed" B): SBO = 1024 (the next
//   8 k rows), LBO = the byte distance to the next 64-wide n box; a k16
//   step adds 16 rows = 2048 bytes.
// - Accumulator fragment of m64nN (per warp w of the warpgroup, rows
//   16w..16w+15; g = lane / 4, t = lane % 4): d[4j + e] holds row
//   g + 8 * (e >> 1), column 8j + 2t + (e & 1). The A fragment of the RS
//   form is mma.sync's m16n8k16 A fragment of the warp's 16 rows.
#pragma once

#include <cuda.h>  // CUtensorMap and CUresult types only: no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Stores clip at the tensor's bounds: rows or columns past them are not
// written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Adds a shared-memory box into global memory, element by element, as one
// bulk operation (f32 add for an f32 tensor map); clipped at the tensor's
// bounds like a store, and tracked by the same bulk groups.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's stores have finished reading shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The issuing thread's stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier over `threads` threads (a multiple of 32) on hardware barrier id.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------- registers, shared loads
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives lane's (row lane / 4, columns 2 (lane % 4) + {0, 1})
// of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// 2^x on the SFU (one MUFU.EX2); subnormal results flush to zero.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Two floats rounded to the wgmma operand type of H (bf16, or f16 when H).
template <bool H>
__device__ __forceinline__ uint32_t pack_x2(float lo, float hi) {
  if constexpr (H) {
    uint32_t r;
    asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
  } else {
    return pack_bf16x2(lo, hi);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The low and high halves of a word of two bf16 (f16 when H) as f32.
template <bool H>
__device__ __forceinline__ float lo_x2(uint32_t x) {
  if constexpr (H)
    return __half2float(__ushort_as_half((unsigned short)(x & 0xffffu)));
  else
    return bf16_lo(x);
}

template <bool H>
__device__ __forceinline__ float hi_x2(uint32_t x) {
  if constexpr (H)
    return __half2float(__ushort_as_half((unsigned short)(x >> 16)));
  else
    return bf16_hi(x);
}

// Keeps the compiler from moving register reads or writes of `d` across
// this point (wgmma reads and writes its registers asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A fragment set of several k16 steps: keeps it live (and unmoved) until
// this point, past the wgmma_wait that retires the wgmmas reading it.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) fence_regs(r[k]);
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled bf16 tile at
// shared address `addr`; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// In the forms below scale_d = 0 overwrites d, 1 accumulates into it, and
// TransB = 1 reads an MN-major B. H picks the operand type: bf16 (false)
// or f16 (true); both accumulate in f32, and the tiles, descriptors and
// fragments are laid out alike (two bytes an element).

#define SM90_ACC32 \
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define SM90_ACC64 \
      SM90_ACC32, \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63])
#define SM90_REGS32 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define SM90_REGS64 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

#define SM90_SS_N128(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               SM90_REGS64 "%64, %65, p, 1, 1, 0, %67;\n}\n"                \
               : SM90_ACC64                                                 \
               : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TransB))

#define SM90_SS_N64(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_REGS32 "%32, %33, p, 1, 1, %36, %35;\n}\n"              \
               : SM90_ACC32                                                 \
               : "l"(a_desc), "l"(b_desc), "r"(scale_d), "n"(TransB),       \
                 "n"(TransA))

#define SM90_RS_N64(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               SM90_REGS32 "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"  \
               : SM90_ACC32                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),   \
                 "r"(scale_d), "n"(TransB))

#define SM90_RS_N128(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               SM90_REGS64 "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"  \
               : SM90_ACC64                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),   \
                 "r"(scale_d), "n"(TransB))

// d[64] (+)= A . B for m64n128k16, A and B from shared memory.
template <int TransB, bool H = false>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a_desc,
                                             uint64_t b_desc, int scale_d) {
  if constexpr (H) SM90_SS_N128("f16"); else SM90_SS_N128("bf16");
}

// d[32] (+)= A . B for m64n64k16, A and B from shared memory; TransA = 1
// reads an MN-major A (m contiguous), described as an MN-major B is.
template <int TransB, int TransA = 0, bool H = false>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a_desc,
                                            uint64_t b_desc, int scale_d) {
  if constexpr (H) SM90_SS_N64("f16"); else SM90_SS_N64("bf16");
}

// d[32] (+)= A . B for m64n64k16, A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory.
template <int TransB, bool H = false>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
  if constexpr (H) SM90_RS_N64("f16"); else SM90_RS_N64("bf16");
}

// d[64] (+)= A . B for m64n128k16, A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory.
template <int TransB, bool H = false>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b_desc, int scale_d) {
  if constexpr (H) SM90_RS_N128("f16"); else SM90_RS_N128("bf16");
}

#undef SM90_SS_N128
#undef SM90_SS_N64
#undef SM90_RS_N64
#undef SM90_RS_N128
#undef SM90_REGS32
#undef SM90_REGS64
#undef SM90_ACC64
#undef SM90_ACC32

// ------------------------------------------ attention backward tiles
// A consumer warpgroup of the flash backward kernels owns 64 rows of a
// 128-row tile; the helpers below move its fragments between registers and
// 128-byte-swizzled shared tiles and issue its products.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float f32_inf() {
  return __int_as_float(0x7f800000);
}

// A consumer's accumulator (rows 16 * warp + g + 8h of its 64, columns
// 8j + 2t + {0, 1}) into rows 64c.. of a swizzled bf16 (f16 when H) tile
// made of D / 64 column boxes `box` bytes apart, each value times `mul`.
template <int D, bool H = false>
__device__ __forceinline__ void stage_rows(uint8_t* tile, uint32_t box,
                                           const float (&acc)[D / 2],
                                           float mul, int c, int warp, int g,
                                           int t4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 64 * c + 16 * warp + g + 8 * h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int chunk = (j & 7) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(tile + (j >> 3) * box + row * 128 +
                                   chunk * 16 + 4 * t4) =
          pack_x2<H>(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
    }
  }
}

// acc[D/2] += A . B over one k16 step, D in {64, 128, 192, 256}: A the
// bf16 fragments `a`, B the 16 rows at `b` of an MN-major [k][D] tile whose
// 64-column boxes lie `box` bytes apart. An m64nN accumulator is its n64
// pieces one after another (column 8j + 2t + (e & 1) sits at 4j + e), so
// D = 192 is one n128 and one n64 product, D = 256 two n128.
template <int D, bool H = false>
__device__ __forceinline__ void rs_step(float (&acc)[D / 2],
                                        const uint32_t (&a)[4], uint32_t b,
                                        uint32_t box) {
  static_assert(D % 64 == 0 && D <= 256, "D is 64, 128, 192 or 256");
#pragma unroll
  for (int p = 0; p < D / 128; ++p)
    wgmma_rs_n128<1, H>(*reinterpret_cast<float(*)[64]>(acc + 64 * p), a,
                     desc_b128(b + 2 * p * box, box, 1024), 1);
  if constexpr (D % 128 != 0)
    wgmma_rs_n64<1, H>(*reinterpret_cast<float(*)[32]>(acc + D / 2 - 32), a,
                    desc_b128(b + (D / 64 - 1) * box, box, 1024), 1);
}

// acc[D/2] += A . B over k = 64 (four k16 steps): A the bf16 fragments
// `a`, B an MN-major [64][D] tile at `b` whose 64-column boxes lie `box`
// bytes apart.
template <int D, bool H = false>
__device__ __forceinline__ void rs_k64(float (&acc)[D / 2],
                                       const uint32_t (&a)[4][4], uint32_t b,
                                       uint32_t box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_step<D, H>(acc, a[kk], b + kk * 16 * 128, box);
}

// d[32] = A . B^T over k = D: A the 64 rows at `a` of a K-major tile whose
// 64-column boxes lie `a_box` bytes apart, B a K-major [64][D] tile at `b`
// with boxes `b_box` apart.
template <int D, bool H = false>
__device__ __forceinline__ void ss_n64(float (&d)[32], uint32_t a,
                                       uint32_t a_box, uint32_t b,
                                       uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64<0, 0, H>(d, desc_b128(a + (kk / 4) * a_box + col, 16, 1024),
                    desc_b128(b + (kk / 4) * b_box + col, 16, 1024), kk > 0);
  }
}

// The 16 bf16 (f16 when H) A fragments of a 64 x 64 accumulator, rounded
// in registers.
template <bool H = false>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_x2<H>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

}  // namespace sm90

// ----------------------------------------------------- host: tensor maps
namespace sm90_host {

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A tensor map (bf16 unless `type` says otherwise) with 128-byte swizzle
// over a row-major tensor: dims innermost first, strides (bytes) of dims
// 1..rank-1, box in elements (its inner extent at most 128 bytes).
// Out-of-bounds box elements load as zero.
inline bool make_map(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const uint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank,
            const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a row-major [bh, s, d] bf16 (f16 when `f16`) tensor
// (attention's kernel layout) with boxes of 64 columns x `rows` rows. d is
// the tensor's own width (a multiple of 8: TMA takes row strides of 16-byte
// multiples); a box column at or past d loads as zero and is not stored.
inline bool map_rows(CUtensorMap* map, const void* p, int bh, int s, int d,
                     int rows, bool f16 = false) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)s, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)d * 2, (uint64_t)s * d * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return make_map(map, p, 3, dims, strides, box,
                  f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// A map over a row-major [bh, s, d] f32 tensor (d a multiple of 4) with
// boxes of 32 columns (128 bytes, the widest box the swizzle takes) x
// `rows` rows.
inline bool map_rows_f32(CUtensorMap* map, const void* p, int bh, int s,
                         int d, int rows) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)s, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)d * 4, (uint64_t)s * d * 4};
  const uint32_t box[3] = {32, (uint32_t)rows, 1};
  return make_map(map, p, 3, dims, strides, box,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace sm90_host
