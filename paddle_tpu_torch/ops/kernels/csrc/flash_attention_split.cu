// Flash attention split backward for Hopper (sm_90a): a dq pass and a dk/dv
// pass, each free of atomics.
//
// Replaces the two Pallas TPU kernels that paddle_tpu/ops/pallas/
// flash_attention.py's `_bwd_impl` (:472) takes when the fused backward's
// dq scratch rep * sq * d * 4 bytes exceeds 8 MiB (:498-502):
// - `_bwd_dq_kernel` (:283, pallas_call at :515):
//     dq = scale * sum_k dS K,  dS = P (dO V^T - delta),  P = exp(S - lse);
// - `_bwd_dkv_kernel` (:324, pallas_call at :539):
//     dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q, over the rep q heads
//     that share the kv head.
// delta = rowsum(dO * O) and lse come from the caller. Layout [B*H, S, D];
// q head bh reads kv head bh / rep (`_kv_index` :166). Causal masking
// aligns the queries to the end of the keys: row i sees key j when
// j <= i + (Sk - Sq).
//
// Roundings kept from the Pallas kernels: in the dq pass P stays f32 and dS
// is rounded to k's type before dS K (:308); in the dk/dv pass P is rounded
// to do's type before P^T dO (:348) and dS to q's type before dS^T Q
// (:356). The f32 dq body scales each tile's f32 product before it joins
// the sum (:307); the bf16 kernels and the f32 dk/dv body scale dq and dK
// once, after the sum.
//
// Bound: at the long-context shape (S = 32768, D = 128, causal) the dq pass
// does 6 * D multiply-add operations per visible (query, key) pair
// (S = QK^T, dP = dO V^T, dS K) and the dk/dv pass 8 * D (the same two
// products, P^T dO and dS^T Q), against 4 * S * D * 2 bytes per head; both
// sit far above the card's ~295 FLOP/byte ridge, so the bf16 tensor-core
// rate bounds them.
//
// Head widths: every d <= 256 whose rows are whole 16-byte vectors, on a
// padded width DP of 64, 128, 192 or 256 columns, the tensor maps carrying
// the real d (TMA loads the columns past d as zeros and clips them on
// store), as in csrc/flash_attention.cu.
//
// bf16 (and float16, the same kernels with H = true, as in
// csrc/flash_attention.cu): FA3-style kernels on sm90.cuh, three
// warpgroups a block.
// Warpgroup 0 is the producer (registers cut to 24 by setmaxnreg); warpgroups
// 1 and 2 are consumers (240 registers) that own 64 rows each of the
// block's 128-row tile. Tiles arrive by TMA (128-byte swizzle) on mbarriers;
// TMA's zero fill covers rows past Sq and keys past Sk. exp is one FFMA
// folding scale * log2(e) and -lse * log2(e), then ex2.approx; a query
// row past Sq carries lse = +inf, so its p is 0 without a test. Only tiles
// that straddle the causal diagonal or the ragged key edge are masked.
// - dq (`flash_bwd_dq_wgmma`): one block per (q head, 128-row q tile), the
//   longest causal tiles first. Q and dO are loaded once; K and V stream
//   in 64-key tiles through rings up to the causal diagonal (tiles wholly
//   above it are never loaded, the `pl.when` at :312): 3 stages each up to
//   DP = 128; 2 each at DP = 192; at DP = 256, where Q and dO alone take
//   128 KB, 2 of K and 1 of V (224 KB in all). K of tile j is released
//   after dq += dS K of tile j, during tile j + 1, so it needs two stages.
//   Per tile a consumer issues S = Q K^T and dP = dO V^T (wgmma SS
//   m64n64k16, K and V K-major), forms P while dP is on the tensor cores,
//   then dS rounded to bf16 in registers: the A operand of dq += dS K
//   (wgmma RS, K read MN-major from the same swizzled tile). dq of tile j
//   runs beside S and dP of tile j + 1 (up to DP = 192; at DP = 256 the dq
//   accumulator's 128 registers leave no room for both, so dq is waited
//   for first). dq stays in f32 registers, is scaled once and is stored by
//   TMA (clipped at Sq and d) from the consumer's rows of the Q tile.
// - dk/dv, DP of 64 or 128 (`flash_bwd_dkv_wgmma`): one block per (kv
//   head, 128-key tile), the longest (lowest keys, causal) first. K and V
//   are loaded once; Q and dO stream in 64-row tiles through a 3-stage ring
//   that walks the rep q heads in turn, each from the causal clamp
//   (`_clamp_qi` :227), with no drain between heads. The producer's first
//   warp stages each tile's lse (times log2(e)) and delta in shared memory
//   beside it: those are per-column values here and Sq * 4 bytes need not
//   be TMA-aligned. Each consumer computes transposed, as FA3 does:
//   S^T = K Q^T and dP^T = V dO^T by SS (Q and dO K-major), P^T and dS^T
//   rounded to bf16 in registers as the RS A operands of dV += P^T dO and
//   dK += dS^T Q (dO and Q MN-major from the same tiles). dK (scaled once)
//   and dV leave through the consumer's rows of the K and V tiles by TMA
//   stores clipped at Sk and d.
// - dk/dv, DP of 192 or 256: `flash_bwd_wide_wgmma<DP, false>`
//   (csrc/flash_bwd_wide.cuh), whose two consumers own dV and dK of the
//   same 64 keys.
// - No atomics and one fixed order: two runs give the same bits.
// f32: the column-chunked bodies of csrc/flash_f32.cuh (for the checks);
// every output element is written by one thread after a loop in a fixed
// order.
#include "flash_bwd_wide.cuh"
#include "flash_f32.cuh"
#include "sm90.cuh"

namespace {

// --------------------------------------------------- bf16 (TMA + wgmma)
template <int D>
struct DqWg {
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kQBox = 128 * 128;       // [128 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr uint32_t kKBox = 64 * 128;        // [64 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr int kKStages = D <= 128 ? 3 : 2;  // of K
  static constexpr int kVStages = D <= 128 ? 3 : D == 192 ? 2 : 1;  // of V
  // dq of tile j overlaps S and dP of tile j + 1 while registers allow
  static constexpr bool kOverlap = D <= 192;
  static constexpr uint32_t kDoOff = kQTile;
  static constexpr uint32_t kKOff = 2 * kQTile;
  static constexpr uint32_t kVOff = kKOff + kKStages * kKTile;
  static constexpr uint32_t kBarOff = kVOff + kVStages * kKTile;
  // barriers: K full/empty (kKStages each), V full/empty (kVStages each),
  // then Q and dO
  static constexpr size_t kSmem =
      kBarOff + (2 * kKStages + 2 * kVStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int D, bool H>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap dq_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int rep, int sq,
                       int sk, float scale, int causal) {
  using L = DqWg<D>;
  constexpr int SK = L::kKStages, SV = L::kVStages;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t k_full = base + L::kBarOff, k_empty = k_full + 8 * SK,
                 v_full = k_empty + 8 * SK, v_empty = v_full + 8 * SV,
                 q_bar = v_empty + 8 * SV;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // longest tiles first
  const int offset = sk - sq;
  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + 128, sq) + offset);
  const int n_kt = k_end > 0 ? (k_end + 63) / 64 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < SK; ++i) {
      sm90::mbar_init(k_full + 8 * i, 1);
      sm90::mbar_init(k_empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < SV; ++i) {
      sm90::mbar_init(v_full + 8 * i, 1);
      sm90::mbar_init(v_empty + 8 * i, 8);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_bar, 2 * L::kQTile);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        sm90::tma_load_3d(base + b * L::kQBox, &q_map, q_bar, 64 * b, q0, bh);
        sm90::tma_load_3d(base + L::kDoOff + b * L::kQBox, &do_map, q_bar,
                          64 * b, q0, bh);
      }
      const int bhk = bh / rep;
      for (int j = 0; j < n_kt; ++j) {
        const int sk_ = j % SK, sv = j % SV;
        sm90::mbar_wait(k_empty + 8 * sk_, ((j / SK) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full + 8 * sk_, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kKOff + sk_ * L::kKTile + b * L::kKBox,
                            &k_map, k_full + 8 * sk_, 64 * b, 64 * j, bhk);
        sm90::mbar_wait(v_empty + 8 * sv, ((j / SV) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(v_full + 8 * sv, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kVOff + sv * L::kKTile + b * L::kKBox,
                            &v_map, v_full + 8 * sv, 64 * b, 64 * j, bhk);
      }
    }
  } else {  // ------------------------------------------------ consumers
    sm90::reg_alloc<240>();
    const int c = wg - 1, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + 64 * c;  // this consumer's first row
    const int rows[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
    // k tiles that hold a key some row of this consumer sees
    int n_wg = n_kt;
    if (wq0 >= sq)
      n_wg = 0;
    else if (causal)
      n_wg = max(0, min(sk, min(wq0 + 64, sq) + offset) + 63) / 64;
    const float sl2 = scale * sm90::kLog2e;
    // lse * log2(e) (+inf past Sq: p = 0) and delta of this thread's rows
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < sq;
      lse2[h] = in ? lse[(size_t)bh * sq + rows[h]] * sm90::kLog2e
                    : sm90::f32_inf();
      del[h] = in ? delta[(size_t)bh * sq + rows[h]] : 0.f;
    }

    float dq[D / 2], s[32], dp[32];
    uint32_t dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    auto release_k = [&](int j) {
      if (lane == 0) sm90::mbar_arrive(k_empty + 8 * (j % SK));
    };
    auto release_v = [&](int j) {
      if (lane == 0) sm90::mbar_arrive(v_empty + 8 * (j % SV));
    };
    const uint32_t q_rows = base + c * 64 * 128;  // this consumer's Q rows
    const uint32_t do_rows = base + L::kDoOff + c * 64 * 128;

    sm90::mbar_wait(q_bar, 0);
    for (int j = 0; j < n_wg; ++j) {
      const uint32_t ks = base + L::kKOff + (j % SK) * L::kKTile;
      const uint32_t vs = base + L::kVOff + (j % SV) * L::kKTile;
      sm90::mbar_wait(k_full + 8 * (j % SK), (j / SK) & 1);
      sm90::wgmma_fence();
      sm90::ss_n64<D, H>(s, q_rows, L::kQBox, ks, L::kKBox);
      sm90::wgmma_commit();
      sm90::mbar_wait(v_full + 8 * (j % SV), (j / SV) & 1);
      sm90::ss_n64<D, H>(dp, do_rows, L::kQBox, vs, L::kKBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // dq of tile j - 1 and S of tile j are done
      sm90::fence_regs(s);
      if (j > 0) {
        sm90::fence_regs(dsa);
        release_k(j - 1);
      }
      const int k0 = 64 * j;
      const bool masked =
          k0 + 64 > sk || (causal && k0 + 63 > wq0 + offset);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float p = sm90::ex2_approx(fmaf(s[i], sl2, -lse2[h]));
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (col >= sk || (causal && col > rows[h] + offset)) p = 0.f;
        }
        s[i] = p;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      release_v(j);
      // dS = P (dP - delta), rounded to k's type (:306-310)
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del[(i >> 1) & 1]);
      sm90::pack_frags<H>(dsa, dp);
      sm90::wgmma_fence();
      sm90::rs_k64<D, H>(dq, dsa, ks, L::kKBox);  // dq += dS K, K MN-major
      sm90::wgmma_commit();
      if constexpr (!L::kOverlap) {
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        sm90::fence_regs(dsa);
      }
    }
    if (n_wg > 0) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dsa);
      release_k(n_wg - 1);
    }
    for (int j = n_wg; j < n_kt; ++j) {  // tiles none of these rows sees
      sm90::mbar_wait(k_full + 8 * (j % SK), (j / SK) & 1);
      release_k(j);
      sm90::mbar_wait(v_full + 8 * (j % SV), (j / SV) & 1);
      release_v(j);
    }

    // epilogue: scale * dq into this consumer's rows of the Q tile, then TMA
    sm90::stage_rows<D, H>(smem, L::kQBox, dq, scale, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0 && wq0 < sq) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_store_3d(&dq_map, q_rows + b * L::kQBox, 64 * b, wq0, bh);
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int D>
struct DkvWg {
  static_assert(D == 64 || D == 128, "wider tiles: flash_bwd_wide.cuh");
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kKBox = 128 * 128;       // [128 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr uint32_t kQBox = 64 * 128;        // [64 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr int kStages = 3;                  // of Q, dO and rows
  static constexpr uint32_t kVOff = kKTile;
  static constexpr uint32_t kQOff = 2 * kKTile;
  static constexpr uint32_t kDoOff = kQOff + kStages * kQTile;
  // per stage: 64 lse * log2(e), then 64 delta (f32)
  static constexpr uint32_t kRowOff = kDoOff + kStages * kQTile;
  static constexpr uint32_t kBarOff = kRowOff + kStages * 512;
  // barriers: full/empty (kStages each), then K and V
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

template <int D, bool H>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap dk_map,
                        const __grid_constant__ CUtensorMap dv_map,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, int rep, int sq,
                        int sk, float scale, int causal) {
  using L = DkvWg<D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t full = base + L::kBarOff, empty = full + 8 * S,
                 kv_bar = empty + 8 * S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bhk = blockIdx.x, k0 = blockIdx.y * 128;  // lowest keys first
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
        sm90::mbar_arrive_expect_tx(kv_bar, 2 * L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_load_3d(base + b * L::kKBox, &k_map, kv_bar, 64 * b, k0,
                            bhk);
          sm90::tma_load_3d(base + L::kVOff + b * L::kKBox, &v_map, kv_bar,
                            64 * b, k0, bhk);
        }
      }
      for (int it = 0; it < n_items; ++it) {
        const int st = it % S;
        const int bh = bhk * rep + it / n_qt;
        const int q0 = q_begin + (it % n_qt) * 64;
        sm90::mbar_wait(empty + 8 * st, ((it / S) & 1) ^ 1);
        // lse * log2(e) (+inf past Sq: p = 0) and delta of the tile's rows
        float* rows = reinterpret_cast<float*>(smem + L::kRowOff + st * 512);
        for (int i = tid; i < 64; i += 32) {
          const bool in = q0 + i < sq;
          const size_t at = (size_t)bh * sq + q0 + i;
          rows[i] = in ? lse[at] * sm90::kLog2e : sm90::f32_inf();
          rows[64 + i] = in ? delta[at] : 0.f;
        }
        if (tid == 0) {
          sm90::mbar_arrive_expect_tx(full + 8 * st, 2 * L::kQTile);
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b) {
            sm90::tma_load_3d(base + L::kQOff + st * L::kQTile + b * L::kQBox,
                              &q_map, full + 8 * st, 64 * b, q0, bh);
            sm90::tma_load_3d(base + L::kDoOff + st * L::kQTile +
                                  b * L::kQBox,
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
    const int kc0 = k0 + 64 * c;  // this consumer's first key
    const int keys[2] = {kc0 + 16 * warp + g, kc0 + 16 * warp + g + 8};
    const float sl2 = scale * sm90::kLog2e;
    const uint32_t k_rows = base + c * 64 * 128;  // this consumer's keys
    const uint32_t v_rows = base + L::kVOff + c * 64 * 128;

    float dk[D / 2], dv[D / 2], s[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % S;
      const int q0 = q_begin + (it % n_qt) * 64;
      sm90::mbar_wait(full + 8 * st, (it / S) & 1);
      // skip a tile none of this consumer's keys is seen from (or keys
      // past Sk only)
      if (kc0 < sk && (!causal || kc0 <= q0 + 63 + offset)) {
        const uint32_t qs = base + L::kQOff + st * L::kQTile;
        const uint32_t dos = base + L::kDoOff + st * L::kQTile;
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRowOff + st * 512);
        sm90::wgmma_fence();
        sm90::ss_n64<D, H>(s, k_rows, L::kKBox, qs, L::kQBox);  // S^T = K Q^T
        sm90::wgmma_commit();
        sm90::ss_n64<D, H>(dp, v_rows, L::kKBox, dos, L::kQBox);  // dP^T = V dO^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        // row = key, column = query: visible when key <= query + offset
        const bool masked = causal && kc0 + 63 > q0 + offset;
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
        // P^T rounded to do's type (:347-350), dS^T to q's type (:354-358)
        sm90::pack_frags<H>(pa, s);
        sm90::pack_frags<H>(dsa, dp);
        sm90::wgmma_fence();
        sm90::rs_k64<D, H>(dv, pa, dos, L::kQBox);   // dV += P^T dO, dO MN-major
        sm90::rs_k64<D, H>(dk, dsa, qs, L::kQBox);   // dK += dS^T Q, Q MN-major
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
      }
      if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
    }

    // epilogue: scale * dK and dV into this consumer's rows of the K and V
    // tiles, then TMA (clipped at Sk)
    sm90::stage_rows<D, H>(smem, L::kKBox, dk, scale, c, warp, g, t4);
    sm90::stage_rows<D, H>(smem + L::kVOff, L::kKBox, dv, 1.f, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0 && kc0 < sk) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        sm90::tma_store_3d(&dk_map, k_rows + b * L::kKBox, 64 * b, kc0, bhk);
        sm90::tma_store_3d(&dv_map, v_rows + b * L::kKBox, 64 * b, kc0, bhk);
      }
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int D, bool H>
cudaError_t launch_dq_16bit(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bhq, int rep,
                           int sq, int sk, int d, float scale, int causal,
                           cudaStream_t stream) {
  using L = DqWg<D>;
  const int bhk = bhq / rep;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, d, 128, H) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, d, 128, H) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&dq_map, dq, bhq, sq, d, 64, H))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + 127) / 128);
  flash_bwd_dq_wgmma<D, H><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, (const float*)lse,
      (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <int D, bool H>
cudaError_t launch_dkv_16bit(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bhk,
                            int rep, int sq, int sk, int d, float scale,
                            int causal, cudaStream_t stream) {
  using L = DkvWg<D>;
  const int bhq = bhk * rep;
  CUtensorMap q_map, k_map, v_map, do_map, dk_map, dv_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, d, 128, H) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, d, 128, H) ||
      !sm90_host::map_rows(&dk_map, dk, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&dv_map, dv, bhk, sk, d, 64, H))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, (sk + 127) / 128);
  flash_bwd_dkv_wgmma<D, H><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dk_map, dv_map, (const float*)lse,
      (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q/do/dq [bhq, sq, d], k/v
// [bhq/rep, sk, d], lse/delta [bhq, sq] f32, d <= 256 a multiple of 4 (f32)
// or 8 (bf16, f16). Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for shapes it does not take).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bhq, int rep, int sq,
    int sk, int head_dim, float scale, int causal, int dtype, void* stream) {
  if (!flash_shape_ok(bhq, rep, sq, sk, head_dim, dtype) || bhq % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(head_dim, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    if (dtype == 0)
      return flash_f32::launch_dq<DP>(q, k, v, dout, lse, delta, dq, bhq,
                                      rep, sq, sk, head_dim, scale, causal,
                                      s);
    return dtype == 2
               ? launch_dq_16bit<DP, true>(q, k, v, dout, lse, delta, dq, bhq,
                                           rep, sq, sk, head_dim, scale,
                                           causal, s)
               : launch_dq_16bit<DP, false>(q, k, v, dout, lse, delta, dq,
                                            bhq, rep, sq, sk, head_dim, scale,
                                            causal, s);
  });
}

// dk/dv [bhk, sk, d]; q/do [bhk*rep, sq, d].
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bhk, int rep,
    int sq, int sk, int head_dim, float scale, int causal, int dtype,
    void* stream) {
  if (!flash_shape_ok(bhk, rep, sq, sk, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(head_dim, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    if (dtype == 0)
      return flash_f32::launch_bwd_kv<DP, false>(
          q, k, v, dout, lse, delta, nullptr, dk, dv, bhk, rep, sq, sk,
          head_dim, scale, causal, s);
    auto run = [&](auto h) {
      constexpr bool H = decltype(h)::value;
      if constexpr (DP <= 128)
        return launch_dkv_16bit<DP, H>(q, k, v, dout, lse, delta, dk, dv, bhk,
                                       rep, sq, sk, head_dim, scale, causal,
                                       s);
      else
        return flash_wide::launch<DP, false, H>(
            q, k, v, dout, lse, delta, nullptr, dk, dv, bhk, rep, sq, sk,
            head_dim, scale, causal, s);
    };
    return dtype == 2 ? run(std::true_type{}) : run(std::false_type{});
  });
}
