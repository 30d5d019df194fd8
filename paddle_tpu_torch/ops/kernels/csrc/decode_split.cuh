// decode_split.cuh: the shared body of the one-token decode attention
// kernels for Hopper (sm_90a): paged_attention.cu (exact rows in pages found
// through a block table), decode_attention.cu (a dense cache) and
// paged_attention_int8.cu (int8 codes and one f32 scale per row, in pages).
// It replaces the Pallas TPU kernels `_paged_kernel`, `_decode_kernel` and
// `_paged_int8_kernel` (paddle_tpu/ops/pallas/decode_attention.py:139, :42
// and :180):
//
//   out[b, h*rep + r] = softmax(q[b, h*rep + r] . K_b^T * scale) . V_b
//
// over the first len = lengths[b] rows of sequence b: the softmax in f32,
// 0 where len == 0, table entries clamped to [0, num_pages - 1], and no page
// or row at or past len ever read. Exact rows: p rounded to V's type before
// p.V, with l summed from the unrounded p. Int8 rows: k = code * scale_k and
// v = code * scale_v in f32, q in f32, and p kept in f32.
//
// Bound: each live K and V row is read once, a few FLOPs per byte, so the
// live rows' bytes over the card's memory rate (3.35 TB/s) bound it.
//
// Design:
// - Split sequence. A cluster of n <= 8 CTAs (the portable cluster size)
//   per (sequence, kv head, group of at most 8 q rows of the rep). The host
//   picks n from the most rows the call allows, never from `lengths`, which
//   live on the card. Each CTA reads lengths[b] and takes a contiguous 1/n
//   share of the live rows (whole pages on the paged route, multiples of
//   kDenseAlign rows on the dense one), so n CTAs walk the longest sequence.
//   A rep above 8 runs as several groups of q rows (one grid row each), and
//   each group reads its K/V rows again.
// - Loads in flight. Each of the 4 warps streams its own tiles (every 4th
//   tile of the CTA's share) through its own 2- or 3-stage ring of 16-byte
//   cp.async copies, so the next tiles are in flight while one is reduced.
//   Every row's address comes from its own table entry, so any page size
//   works. Rows past the share or the length are zero-filled and masked,
//   never read. An int8 row's two scales ride beside its codes in the same
//   stage, one 4-byte cp.async each.
// - No barrier per tile. A row is spread over LPR lanes in chunks of 16
//   bytes (f32, bf16) or 8 (int8 codes), at most 8 values a chunk, a warp
//   holding 32 / LPR rows at once; q lives in registers in f32; a
//   score reduces over its row's LPR lanes (log2 LPR shuffles). Each lane
//   group keeps its own (m, l, acc) in registers and updates its online
//   softmax once per tile.
// - Int8 codes become f32 without I2F, which runs at a quarter of the FMA
//   rate: a byte permute puts code ^ 0x80 under the exponent of 2^23, and
//   one subtraction of 2^23 + 128 leaves the code, exactly. Each row's scale
//   stays out of the inner products: the score is scale_k * (q . code_k) *
//   scale, and p.V adds (p * scale_v) * code_v, one product a row in place
//   of D (an f32 reassociation against the plain version).
// - Merge, once, in a fixed order: the lane groups by shuffles, the warps
//   through shared memory (which the rings leave free by then), the CTAs of
//   the cluster through distributed shared memory in rank order 0..n-1,
//   each CTA finishing a slice of the output. One launch per call, no
//   workspace, no atomics, and a call repeats bit for bit. A CTA with no
//   rows contributes (m, l) = (-1e30, 0) and still reaches both cluster
//   barriers.
// - bf16 and f16 q take their exponentials on the SFU (ex2.approx of the
//   score times scale * log2 e); f32 q takes expf.
// - q f32, bf16 or f16; K/V rows of q's type or int8; D in {64, 80, 96, 128,
//   256}; any rep >= 1; any page.
// - Page layout. A paged route finds row `pos` of kv head h at row
//   h * head_stride + tables[pos / page] * page_stride + pos % page of its
//   pages, so the head-major layout [Hkv, num_pages, page, D] (head_stride
//   num_pages * page, page_stride page) and the page-major one
//   [num_pages, Hkv, page, D] (head_stride page, page_stride Hkv * page)
//   are read in place; only the addresses differ.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace decode_split {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRows = 8;      // q rows per CTA: a group of the rep
constexpr int kMaxSplit = 8;     // CTAs per cluster
constexpr int kDenseAlign = 16;  // dense shares are multiples of 16 rows
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;       // [B, Hq, D]
  const void* k;       // paged [Hkv, num_pages, page, D]; dense [B, Hkv, S, D]
  const void* v;
  const float* k_scales;  // int8 route: [Hkv, num_pages, page, 1]
  const float* v_scales;
  const int* tables;   // [B, pages_per_seq] (paged route)
  const int* lengths;  // [B]
  void* out;           // [B, Hq, D]
  int hkv, rep, groups, split;
  int num_pages, page, pages_per_seq;  // paged route
  int head_stride, page_stride;        // paged route, in rows of D values
  int seq;                             // dense route
  float scale;
};

using KernelFn = void (*)(Params);

__host__ __device__ constexpr int next_pow2(int x) {
  return x <= 1 ? 1 : 2 * next_pow2((x + 1) / 2);
}

// How a D-wide row of KV (f32, bf16, f16 or int8 codes) maps onto a warp.
template <typename KV, int D, int R>
struct Shape {
  static constexpr bool kCodes = sizeof(KV) == 1;        // int8 rows
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kCopies = kRowBytes / 16;         // 16-byte copies
  // a lane reads a row in chunks of 16 bytes (f32, bf16) or 8 (int8), so a
  // chunk holds at most 8 values
  static constexpr int kChunkBytes = kCodes ? 8 : 16;
  static constexpr int kChunks = kRowBytes / kChunkBytes;
  static constexpr int kLanes =                          // lanes per row
      next_pow2(kChunks) < 32 ? next_pow2(kChunks) : 32;
  static constexpr int kVecs = (kChunks + kLanes - 1) / kLanes;  // per lane
  static constexpr int kPerChunk = kChunkBytes / (int)sizeof(KV);
  static constexpr int kElems = kVecs * kPerChunk;       // columns per lane
  static constexpr int kGroups = 32 / kLanes;            // rows per warp step
  static constexpr int kRowsPerGroup = R >= 8 ? 2 : 4;   // per tile
  static constexpr int kTileRows = kRowsPerGroup * kGroups;
  static constexpr int kTileBytes = kTileRows * kRowBytes;
  // a stage: the K tile, the V tile, then (int8) their rows' f32 scales
  static constexpr int kScaleBytes = kCodes ? 4 * kTileRows : 0;
  static constexpr int kStageBytes = 2 * (kTileBytes + kScaleBytes);
  // tiles per warp ring: at R <= 2 the registers leave room for more
  // blocks on an SM than a third stage's shared memory would
  static constexpr int kStages = R >= 4 ? 3 : 2;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kMergeBytes =
      4 * (kWarps * R * D + 2 * kWarps * R + R * D + 2 * R);
  static constexpr int kSmemBytes =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static_assert(kRowBytes % 16 == 0, "rows must be whole 16-byte chunks");
  static_assert(kTileRows <= 32, "one lane finds each tile row");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// p rounded to V's type (the identity for f32 and for int8 rows, whose p
// stays f32)
template <typename KV>
__device__ __forceinline__ float round_p(float x) {
  if constexpr (sizeof(KV) == 1)
    return x;
  else
    return to_f32(from_f32<KV>(x));
}

// e^x for f32; for bf16 and f16 2^x, the scores being scaled by log2 e
template <typename T>
__device__ __forceinline__ float ex(float x) {
  if constexpr (sizeof(T) == 4)
    return expf(x);
  else
    return sm90::ex2_approx(x);
}

// Four int8 codes (one 32-bit word, the first in the low byte) as f32,
// without I2F: 0x4B000000 | (code ^ 0x80) is the float 2^23 + code + 128,
// so one subtraction of 2^23 + 128 leaves the code, exactly.
__device__ __forceinline__ void codes_to_f32(uint32_t w, float* dst) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dst[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + k)) -
             8388736.f;
}

// One chunk of shared memory (16 bytes of f32, bf16 or f16, 8 of int8
// codes) as f32 values.
template <typename KV>
__device__ __forceinline__ void unpack(const unsigned char* src, float* dst) {
  if constexpr (sizeof(KV) == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    codes_to_f32(u.x, dst);
    codes_to_f32(u.y, dst + 4);
  } else if constexpr (sizeof(KV) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
    dst[2] = f.z;
    dst[3] = f.w;
  } else {
    constexpr bool kHalf = std::is_same_v<KV, __half>;
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = sm90::lo_x2<kHalf>(w[i]);
      dst[2 * i + 1] = sm90::hi_x2<kHalf>(w[i]);
    }
  }
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (an int8 row's scale); src_bytes 0 writes zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The whole computation of one CTA: grid (split, hkv * groups, B), one
// cluster along x. T is q's and the output's type, KV the rows' (T, or
// int8_t for codes with their scales).
template <typename T, typename KV, int D, int R, bool kPaged>
__device__ __forceinline__ void attend(const Params& p) {
  using S = Shape<KV, D, R>;
  constexpr bool kCodes = S::kCodes;
  constexpr int LPR = S::kLanes, G = S::kGroups, E = S::kElems;
  constexpr int RPG = S::kRowsPerGroup, TR = S::kTileRows;
  constexpr int C = S::kChunks, EPC = S::kPerChunk, CB = S::kChunkBytes;
  constexpr int CP = S::kCopies, EPP = 16 / (int)sizeof(KV);
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float fac[kMaxSplit * kMaxRows];  // merge factors
  __shared__ float lsum[kMaxRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = p.split;
  const int b = blockIdx.z;
  const int h = blockIdx.y / p.groups;
  const int grp = blockIdx.y % p.groups;
  const int r0 = h * p.rep + grp * R;          // first q row of the group
  const int rows = min(R, p.rep - grp * R);    // its live q rows
  const int hq = p.hkv * p.rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR;                  // chunk lane within a row
  const int grow = lane / LPR;                 // row group within the warp
  const float sscale = sizeof(T) == 4 ? p.scale : p.scale * 1.4426950408889634f;

  // ---- this CTA's share [s0, s1) of the live rows
  const int cap = kPaged ? p.pages_per_seq * p.page : p.seq;
  const int len = min(max(p.lengths[b], 0), cap);
  int s0, s1;
  if constexpr (kPaged) {
    const int per = ((len + p.page - 1) / p.page + n - 1) / n;  // pages
    s0 = min(rank * per * p.page, len);
    s1 = min((rank + 1) * per * p.page, len);
  } else {
    const int per =
        ((len + n - 1) / n + kDenseAlign - 1) / kDenseAlign * kDenseAlign;
    s0 = min(rank * per, len);
    s1 = min(s0 + per, len);
  }
  const size_t head_rows = kPaged ? (size_t)h * p.head_stride
                                  : ((size_t)b * p.hkv + h) * p.seq;
  const KV* kb = reinterpret_cast<const KV*>(p.k) + head_rows * D;
  const KV* vb = reinterpret_cast<const KV*>(p.v) + head_rows * D;
  const float* ksb = kCodes ? p.k_scales + head_rows : nullptr;
  const float* vsb = kCodes ? p.v_scales + head_rows : nullptr;
  const int* tab = kPaged ? p.tables + (size_t)b * p.pages_per_seq : nullptr;

  // ---- q in registers, f32: lane sub holds chunks sub + v * LPR
  float q[R][E];
  {
    const T* qb = reinterpret_cast<const T*>(p.q) + ((size_t)b * hq + r0) * D;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) {
        const int ch = sub + v * LPR;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          q[r][v * EPC + e] = (r < rows && ch < C)
                                  ? to_f32(qb[(size_t)r * D + ch * EPC + e])
                                  : 0.f;
      }
  }
  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // ---- the warp's tiles: global tile warp + it * kWarps of the share
  const int ntile = s1 > s0 ? (s1 - s0 + TR - 1) / TR : 0;
  const int nt = ntile > warp ? (ntile - warp + kWarps - 1) / kWarps : 0;
  constexpr int kStages = S::kStages;
  unsigned char* ring = smem + warp * (kStages * S::kStageBytes);

  auto load_tile = [&](int it) {
    const int t0 = s0 + (warp + it * kWarps) * TR;
    int row = 0;  // lane i < TR: tile row i's row index within the head
    int ok = 0;
    if (lane < TR) {
      const int pos = t0 + lane;
      ok = pos < s1;
      if (ok) {
        if constexpr (kPaged) {
          const int pg = min(max(tab[pos / p.page], 0), p.num_pages - 1);
          row = pg * p.page_stride + pos % p.page;
        } else {
          row = pos;
        }
      }
    }
    unsigned char* dk = ring + (it % kStages) * S::kStageBytes;
    unsigned char* dv = dk + S::kTileBytes;
#pragma unroll
    for (int j = 0; j < (TR * CP + 31) / 32; ++j) {
      const int c = lane + 32 * j;
      const int i = min(c / CP, TR - 1);
      const int ri = __shfl_sync(kAll, row, i);
      const int oki = __shfl_sync(kAll, ok, i);
      if (c < TR * CP) {
        const size_t off = (size_t)ri * D + (c % CP) * EPP;
        cp_async16(dk + c * 16, oki ? kb + off : kb, oki ? 16 : 0);
        cp_async16(dv + c * 16, oki ? vb + off : vb, oki ? 16 : 0);
      }
    }
    if constexpr (kCodes) {  // tile row `lane`'s scales
      if (lane < TR) {
        float* sk = reinterpret_cast<float*>(dv + S::kTileBytes);
        cp_async4(sk + lane, ok ? ksb + row : ksb, ok ? 4 : 0);
        cp_async4(sk + TR + lane, ok ? vsb + row : vsb, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nt) load_tile(st);
    cp_async_commit();
  }
  for (int it = 0; it < nt; ++it) {
    if (it + kStages - 1 < nt) load_tile(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile it has landed (this lane's part)
    __syncwarp();                  // ... and every lane's
    const int t0 = s0 + (warp + it * kWarps) * TR;
    const unsigned char* tk = ring + (it % kStages) * S::kStageBytes;
    const unsigned char* tv = tk + S::kTileBytes;
    const float* tks = reinterpret_cast<const float*>(tv + S::kTileBytes);
    float s[RPG][R];
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      const int i = grow + G * j;
      float kf[E];
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) {
        const int ch = sub + v * LPR;
        if (ch < C) {
          unpack<KV>(tk + i * S::kRowBytes + ch * CB, kf + v * EPC);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[v * EPC + e] = 0.f;
        }
      }
      // the row's scale_k (int8) folded into the softmax scale
      const float rscale = kCodes ? tks[i] * sscale : sscale;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(q[r][e], kf[e], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(kAll, part, o);
        s[j][r] = part * rscale;
      }
    }
    bool valid[RPG];
#pragma unroll
    for (int j = 0; j < RPG; ++j) valid[j] = t0 + grow + G * j < s1;
    // online softmax of this lane group's rows of the tile
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < RPG; ++j)
        if (valid[j]) mx = fmaxf(mx, s[j][r]);
      const float alpha = ex<T>(m[r] - mx);
      m[r] = mx;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RPG; ++j) {
        const float pj = valid[j] ? ex<T>(s[j][r] - mx) : 0.f;
        psum += pj;
        s[j][r] = round_p<KV>(pj);
      }
      l[r] = alpha * l[r] + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      const int i = grow + G * j;
      float vf[E];
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) {
        const int ch = sub + v * LPR;
        if (ch < C) {
          unpack<KV>(tv + i * S::kRowBytes + ch * CB, vf + v * EPC);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) vf[v * EPC + e] = 0.f;
        }
      }
      // int8: p times the row's scale_v, then times the codes
      const float sv = kCodes ? tks[TR + i] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pv = kCodes ? s[j][r] * sv : s[j][r];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
      }
    }
    __syncwarp();  // the stage is free for the load of tile it + kStages
  }
  cp_async_wait<0>();

  // ---- merge the lane groups of the warp (xor over the row-group bits)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(kAll, m[r], o);
      const float lo = __shfl_xor_sync(kAll, l[r], o);
      const float mx = fmaxf(m[r], mo);
      const float a = ex<T>(m[r] - mx), c = ex<T>(mo - mx);
      l[r] = l[r] * a + lo * c;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(kAll, acc[r][e], o) * c;
    }
  }

  // ---- merge the warps in warp order; the rings are free now
  __syncthreads();
  float* W = reinterpret_cast<float*>(smem);  // [kWarps][R][D]
  float* Wm = W + kWarps * R * D;             // [kWarps][R]
  float* Wl = Wm + kWarps * R;
  float* Cacc = Wl + kWarps * R;              // [R][D]: the CTA's partial
  float* Cm = Cacc + R * D;                   // [R]
  float* Cl = Cm + R;
  if (grow == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) {
        const int ch = sub + v * LPR;
        if (ch < C) {
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            W[(warp * R + r) * D + ch * EPC + e] = acc[r][v * EPC + e];
        }
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Wm[warp * R + r] = m[r];
      Wl[warp * R + r] = l[r];
    }
  }
  __syncthreads();
  if (tid < R) {
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Wm[w * R + tid]);
    float ls = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = ex<T>(Wm[w * R + tid] - mx);
      fac[w * R + tid] = f;
      ls += Wl[w * R + tid] * f;
    }
    Cm[tid] = mx;
    Cl[tid] = ls;
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += W[w * R * D + e] * fac[w * R + r];
    Cacc[e] = a;
  }

  // ---- merge the cluster's CTAs in rank order, a slice of the output each
  cluster.sync();
  if (tid < rows) {
    float mx = kNegInf;
    for (int k = 0; k < n; ++k)
      mx = fmaxf(mx, *cluster.map_shared_rank(Cm + tid, k));
    float ls = 0.f;
    for (int k = 0; k < n; ++k) {
      const float f = ex<T>(*cluster.map_shared_rank(Cm + tid, k) - mx);
      fac[k * R + tid] = f;
      ls += *cluster.map_shared_rank(Cl + tid, k) * f;
    }
    lsum[tid] = ls;
  }
  __syncthreads();
  {
    const int total = rows * D;
    const int per = (total + n - 1) / n;
    const int e1 = min((rank + 1) * per, total);
    T* ob = reinterpret_cast<T*>(p.out) + ((size_t)b * hq + r0) * D;
    for (int e = rank * per + tid; e < e1; e += kThreads) {
      const int r = e / D;
      float a = 0.f;
      for (int k = 0; k < n; ++k)
        a += *cluster.map_shared_rank(Cacc + e, k) * fac[k * R + r];
      const float ls = lsum[r];
      ob[e] = from_f32<T>(a / (ls == 0.f ? 1.f : ls));
    }
  }
  cluster.sync();  // peers may still read this CTA's partial until here
}

// ------------------------------------------------------------------ host
template <typename T, int D, int R, typename K>
cudaError_t launch_one(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem =
      Shape<typename K::template Rows<T>, D, R>::kSmemBytes;
  const KernelFn fn = K::template get<T, D, R>();
  static bool ready = false;  // the opt-in above 48 KB, once per kernel
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, p.hkv * p.groups, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, p);
}

template <typename T, int D, typename K>
cudaError_t launch_rows(const Params& p, int batch, int rmax,
                        cudaStream_t stream) {
  switch (rmax) {
    case 1: return launch_one<T, D, 1, K>(p, batch, stream);
    case 2: return launch_one<T, D, 2, K>(p, batch, stream);
    case 4: return launch_one<T, D, 4, K>(p, batch, stream);
    default: return launch_one<T, D, 8, K>(p, batch, stream);
  }
}

template <typename T, typename K>
cudaError_t launch_width(const Params& p, int batch, int head_dim, int rmax,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_rows<T, 64, K>(p, batch, rmax, stream);
    case 80: return launch_rows<T, 80, K>(p, batch, rmax, stream);
    case 96: return launch_rows<T, 96, K>(p, batch, rmax, stream);
    case 128: return launch_rows<T, 128, K>(p, batch, rmax, stream);
    case 256: return launch_rows<T, 256, K>(p, batch, rmax, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K::get<T, D, R>() names the __global__ kernel of one route and
// K::Rows<T> its K/V row type for q of type T. The q rows of a kv head run
// in groups of R = the power of two >= min(rep, 8). dtype (of q): 0
// float32, 1 bfloat16, 2 float16. Returns the launch's error (cudaErrorInvalidValue
// for shapes the kernels do not take).
template <typename K>
int launch(Params p, int batch, int head_dim, int dtype, cudaStream_t stream) {
  if (batch < 1 || p.hkv < 1 || p.rep < 1 || p.split < 1 ||
      p.split > kMaxSplit || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int rmax = p.rep >= 8 ? 8 : next_pow2(p.rep);
  p.groups = (p.rep + rmax - 1) / rmax;
  const cudaError_t err =
      dtype == 0   ? launch_width<float, K>(p, batch, head_dim, rmax, stream)
      : dtype == 1 ? launch_width<__nv_bfloat16, K>(p, batch, head_dim, rmax,
                                                    stream)
                   : launch_width<__half, K>(p, batch, head_dim, rmax, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace decode_split
