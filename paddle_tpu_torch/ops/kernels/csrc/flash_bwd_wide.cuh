// The bf16 (and, with H, float16) flash backward's dk/dv kernel at padded
// widths DP of 192 and 256 columns, with the fused backward's dq when KDQ
// (csrc/flash_attention.cu) and without it as the split pair's dk/dv pass
// (csrc/flash_attention_split.cu). Narrower widths keep their own kernels, whose two consumers own 64
// keys each at every column.
//
// Why another layout: a consumer that owns dK and dV of 64 keys at DP = 256
// holds 2 x 64 x 256 f32 = 256 registers a thread before anything else, and
// a 128-key K and V tile with two stages of 64-row Q and dO tiles takes
// 256 KB of shared memory. So here a block owns 64 keys, and the two
// consumer warpgroups split the outputs instead of the keys:
// - consumer 0 computes S^T = K Q^T (SS wgmma), P^T = exp2(S^T * scale *
//   log2(e) - lse * log2(e)) rounded to do's type in registers, and
//   dV += P^T dO (RS wgmma) into DP / 2 f32 registers; with KDQ it then
//   forms dQ = dS K for the item, 64 columns at a time (SS wgmma: dS read
//   MN-major from the shared dS^T tile, K MN-major from the resident
//   tile), and adds each [64 q][64] f32 piece, times scale, into the zeroed
//   workspace by two TMA reduce-adds (clipped at Sq and at d);
// - consumer 1 computes the same S^T and P^T, dP^T = V dO^T, dS^T = P^T
//   (dP^T - delta) rounded to q's type, writes dS^T into a shared [64 keys]
//   [64 q] tile (two, used in turn) when KDQ, and adds dK += dS^T Q.
// Each consumer does three products of 64 x 64 x DP per item with KDQ
// (S computed twice is the price of the split), two and three without.
// Consumer 0 holds dV (DP / 2) + S (32) + P (16) + one dQ piece (32)
// registers, consumer 1 dK (DP / 2) + S + dP (64) + dS (16).
// The producer warpgroup (24 registers) loads K and V once by TMA and
// streams Q and dO in 64-row tiles through a 2-stage ring that walks the
// rep q heads of the kv head from the causal clamp, staging each tile's
// lse * log2(e) (+inf past Sq) and delta beside it. Shared memory at
// DP = 256: K, V 64 KB, Q and dO 128 KB, dS^T 16 KB, dQ staging 16 KB.
// dK (scaled once) and dV leave by TMA stores clipped at Sk and at d.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace flash_wide {

template <int DP, bool KDQ>
struct Smem {
  static constexpr int kBoxes = DP / 64;            // 64-column boxes
  static constexpr uint32_t kBox = 64 * 128;        // [64 rows][64] bf16
  static constexpr uint32_t kTile = kBoxes * kBox;  // a [64][DP] tile
  static constexpr int kStages = 2;                 // of Q, dO and rows
  static constexpr uint32_t kVOff = kTile;
  static constexpr uint32_t kQOff = 2 * kTile;
  static constexpr uint32_t kDoOff = kQOff + kStages * kTile;
  static constexpr uint32_t kDsOff = kDoOff + kStages * kTile;  // 2 tiles
  // dQ staging: two [64 q][32] f32 boxes (8 KB each)
  static constexpr uint32_t kDqOff = kDsOff + (KDQ ? 2 * kBox : 0);
  // per stage: 64 lse * log2(e), then 64 delta (f32)
  static constexpr uint32_t kRowOff = kDqOff + (KDQ ? 2 * kBox : 0);
  static constexpr uint32_t kBarOff = kRowOff + kStages * 512;
  // barriers: full/empty (kStages each), then K and V
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int DP, bool KDQ, bool H>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_wide_wgmma(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const __grid_constant__ CUtensorMap dk_map,
                         const __grid_constant__ CUtensorMap dv_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int rep, int sq,
                         int sk, float scale, int causal) {
  using L = Smem<DP, KDQ>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t full = base + L::kBarOff, empty = full + 8 * S,
                 kv_bar = empty + 8 * S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bhk = blockIdx.x, k0 = blockIdx.y * 64;  // lowest keys first
  const int offset = sk - sq;
  // the first q tile with a row that sees key k0 (causal clamp); the walk
  // is rep heads x n_qt tiles
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / 64 * 64;
  const int n_qt = (sq - q_begin + 63) / 64;
  const int n_items = rep * n_qt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(full + 8 * i, 32);  // the producer's first warp
      sm90::mbar_init(empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<24>();
    if (tid < 32) {
      if (tid == 0) {
        sm90::mbar_arrive_expect_tx(kv_bar, 2 * L::kTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_load_3d(base + b * L::kBox, &k_map, kv_bar, 64 * b, k0,
                            bhk);
          sm90::tma_load_3d(base + L::kVOff + b * L::kBox, &v_map, kv_bar,
                            64 * b, k0, bhk);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % S;
        const int bh = bhk * rep + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * 64;
        sm90::mbar_wait(empty + 8 * st, ((it / S) & 1) ^ 1);
        float* rows = reinterpret_cast<float*>(smem + L::kRowOff + st * 512);
        for (int i = tid; i < 64; i += 32) {
          const bool in = q0 + i < sq;
          const size_t at = (size_t)bh * sq + q0 + i;
          rows[i] = in ? lse[at] * sm90::kLog2e : sm90::f32_inf();
          rows[64 + i] = in ? delta[at] : 0.f;
        }
        if (tid == 0) {
          sm90::mbar_arrive_expect_tx(full + 8 * st, 2 * L::kTile);
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load_3d(base + L::kQOff + st * L::kTile + b * L::kBox,
                              &q_map, full + 8 * st, 64 * b, q0, bh);
            sm90::tma_load_3d(base + L::kDoOff + st * L::kTile + b * L::kBox,
                              &do_map, full + 8 * st, 64 * b, q0, bh);
          }
        } else {
          sm90::mbar_arrive(full + 8 * st);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::reg_alloc<240>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int keys[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
    const float sl2 = scale * sm90::kLog2e;

    // one body per role, each its own straight-line code: consumer 0 (R =
    // 0) accumulates dV and forms dQ, consumer 1 (R = 1) accumulates dK
    auto consume = [&](auto role) {
      constexpr int R = decltype(role)::value;
      float acc[DP / 2], s[32];
      uint32_t frag[4][4];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

      sm90::mbar_wait(kv_bar, 0);
      for (int it = 0; it < n_items; ++it) {
        const int st = it % S;
        const int bh = bhk * rep + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * 64;
        const uint32_t qs = base + L::kQOff + st * L::kTile;
        const uint32_t dos = base + L::kDoOff + st * L::kTile;
        // every item holds a row that sees key k0: the walk starts at the
        // causal clamp and the block has 64 keys
        sm90::mbar_wait(full + 8 * st, (it / S) & 1);
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRowOff + st * 512);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;  // not carried
        sm90::wgmma_fence();
        sm90::ss_n64<DP, H>(s, base, L::kBox, qs, L::kBox);  // S^T = K Q^T
        sm90::wgmma_commit();
        float dp[32];
        if constexpr (R == 1) {
#pragma unroll
          for (int i = 0; i < 32; ++i) dp[i] = 0.f;
          // dP^T = V dO^T
          sm90::ss_n64<DP, H>(dp, base + L::kVOff, L::kBox, dos, L::kBox);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
        } else {
          sm90::wgmma_wait<0>();
        }
        sm90::fence_regs(s);
        // row = key, column = query: visible when key <= query + offset
        const bool masked = causal && k0 + 63 > q0 + offset;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = sm90::ex2_approx(
                fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x)));
            if (masked &&
                keys[e >> 1] > q0 + 8 * j + 2 * t4 + (e & 1) + offset)
              p = 0.f;
            s[i] = p;
          }
        }
        if constexpr (R == 0) {
          // P^T rounded to do's type (:415): dV += P^T dO, dO MN-major
          sm90::pack_frags<H>(frag, s);
          sm90::wgmma_fence();
          sm90::rs_k64<DP, H>(acc, frag, dos, L::kBox);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          sm90::fence_regs(frag);
          if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
          if constexpr (KDQ) {
            // dS^T of this item from consumer 1; the tile of item it - 2
            // was read by this consumer's dQ products before it reached
            // the barrier of item it - 1
            const uint32_t ds_a = base + L::kDsOff + (it & 1) * L::kBox;
            uint8_t* stage = smem + L::kDqOff;
            sm90::named_bar_sync(3, 256);
#pragma unroll 1
            for (int ch = 0; ch < L::kBoxes; ++ch) {
              float dq[32];
#pragma unroll
              for (int i = 0; i < 32; ++i) dq[i] = 0.f;
              sm90::wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)  // dS read MN-major (q rows)
                sm90::wgmma_ss_n64<1, 1, H>(
                    dq, sm90::desc_b128(ds_a + kk * 16 * 128, L::kBox, 1024),
                    sm90::desc_b128(base + ch * L::kBox + kk * 16 * 128,
                                    L::kBox, 1024),
                    1);
              sm90::wgmma_commit();
              sm90::wgmma_wait<0>();
              sm90::fence_regs(dq);
              // the previous piece's reduce-adds have read the staging
              if (tid == 0) sm90::tma_store_wait_read();
              sm90::named_bar_sync(1, 128);
              // scale * dQ (each tile's product scaled, :428) as two
              // [64 rows][32] f32 boxes, 128-byte swizzled
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = 16 * warp + g + 8 * h;
                  const int chunk = (2 * (j & 3) + (t4 >> 1)) ^ (row & 7);
                  *reinterpret_cast<float2*>(stage + (j >> 2) * L::kBox +
                                             row * 128 + chunk * 16 +
                                             8 * (t4 & 1)) =
                      make_float2(dq[4 * j + 2 * h] * scale,
                                  dq[4 * j + 2 * h + 1] * scale);
                }
              sm90::fence_proxy_async();
              sm90::named_bar_sync(1, 128);
              if (tid == 0) {
                const uint32_t src = sm90::smem_addr(stage);
                sm90::tma_reduce_add_3d(&dq_map, src, 64 * ch, q0, bh);
                sm90::tma_reduce_add_3d(&dq_map, src + L::kBox,
                                        64 * ch + 32, q0, bh);
                sm90::tma_store_commit();
              }
            }
          }
        } else {
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dp);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(rows + 64 + 8 * j + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              dp[i] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
            }
          }
          // dS^T rounded to q's type (:422), and so to k's type for dQ
          // (:428)
          sm90::pack_frags<H>(frag, dp);
          if constexpr (KDQ) {
            uint8_t* ds_tile = smem + L::kDsOff + (it & 1) * L::kBox;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int row = 16 * warp + g + 8 * (r & 1);
                const int chunk = (2 * kk + (r >> 1)) ^ (row & 7);
                *reinterpret_cast<uint32_t*>(ds_tile + row * 128 +
                                             chunk * 16 + 4 * t4) =
                    frag[kk][r];
              }
            sm90::fence_proxy_async();
            sm90::named_bar_sync(3, 256);
          }
          sm90::wgmma_fence();
          sm90::rs_k64<DP, H>(acc, frag, qs, L::kBox);  // dK += dS^T Q
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc);
          sm90::fence_regs(frag);
          if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
        }
      }

      // epilogue: consumer 0's dV into the V tile, consumer 1's scale * dK
      // into the K tile, then TMA (clipped at Sk and d). Each consumer
      // read the other's tile (S^T reads K; dP^T reads V): wait for both.
      sm90::named_bar_sync(3, 256);
      sm90::stage_rows<DP, H>(smem + (R == 0 ? L::kVOff : 0), L::kBox, acc,
                           R == 0 ? 1.f : scale, 0, warp, g, t4);
      sm90::fence_proxy_async();
      sm90::named_bar_sync(1 + R, 128);
      if (tid == 0) {
        if (k0 < sk) {
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b)
            sm90::tma_store_3d(R == 0 ? &dv_map : &dk_map,
                               base + (R == 0 ? L::kVOff : 0) + b * L::kBox,
                               64 * b, k0, bhk);
          sm90::tma_store_commit();
        }
        sm90::tma_store_wait();  // the stores and any dQ reduce-adds
      }
    };
    if (c == 0)
      consume(std::integral_constant<int, 0>{});
    else
      consume(std::integral_constant<int, 1>{});
  }
}

// dq_acc [bhk * rep, sq, d] f32 zeroed (read only with KDQ); dk/dv [bhk,
// sk, d]; d <= DP a multiple of 8.
template <int DP, bool KDQ, bool H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq_acc, void* dk, void* dv, int bhk, int rep, int sq,
                   int sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  using L = Smem<DP, KDQ>;
  const int bhq = bhk * rep;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&dk_map, dk, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&dv_map, dv, bhk, sk, d, 64, H))
    return cudaErrorInvalidValue;
  if (KDQ && !sm90_host::map_rows_f32(&dq_map, dq_acc, bhq, sq, d, 64))
    return cudaErrorInvalidValue;
  if (!KDQ) dq_map = q_map;  // unused
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wide_wgmma<DP, KDQ, H>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, (sk + 63) / 64);
  flash_bwd_wide_wgmma<DP, KDQ, H><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map, (const float*)lse,
      (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_wide
