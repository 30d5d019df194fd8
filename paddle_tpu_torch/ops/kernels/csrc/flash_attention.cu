// Flash attention forward and fused backward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// - the forward `_fwd_kernel` (:113, pallas_call in `_fwd_call` at :248):
//     o = softmax(q k^T * scale, causal mask) v,  lse = m + log(l);
// - the fused single-pass backward `_bwd_fused_kernel` (:373, pallas_call
//   in `_bwd_fused` at :581): dq, dk and dv from (q, k, v, do, lse, delta)
//   with delta = rowsum(do * o) computed by the caller.
// Layout [B*H, S, D]; q head bh reads kv head bh / rep (rep = Hq / Hkv),
// which is the JAX package's `_kv_index`. Causal masking aligns the queries
// to the end of the keys: row i sees key j when j <= i + (Sk - Sq).
//
// Bound: at the training shapes (S = 2048, D = 128) both kernels do about
// S/2 multiply-adds per byte they must move, far above the card's
// ~295 FLOP/byte ridge, so the bf16 tensor-core rate bounds them.
//
// Head widths: every d <= 256 whose rows are whole 16-byte vectors (the
// wrapper pads other widths with zero columns and slices the results).
// The kernels are built for a padded width DP of 64, 128, 192 or 256
// columns (one to four 64-column, 128-byte-swizzled boxes); the tensor maps
// carry the real d, so TMA loads the columns past d as zeros and clips them
// on store. Zero columns of q and k add nothing to q k^T, and zero columns
// of v and do give zero columns of o, dq, dk and dv: the results are exact.
// The scale is the caller's (1/sqrt(d) of the real d).
//
// float16 (dtype 2) runs the bf16 kernels below instantiated with H = true:
// the same tiles, the wgmma forms .f32.f16.f16, p and ds rounded by
// cvt.rn.f16x2.f32 and tensor maps of FLOAT16 (sm90.cuh). fp16's range
// holds p in [0, 1]; its smallest normal, 6e-5, and subnormals down to
// 6e-8 keep what bf16 keeps of p to within the product's rounding.
//
// Forward, bf16: an FA3-style kernel (building blocks in sm90.cuh).
// - One block per (bh, 128-row q tile), the longest causal q tiles first.
//   The TPU's sequential grid dimension over k tiles becomes a loop; tiles
//   wholly above the causal diagonal are never loaded (the `pl.when` at
//   :149).
// - Warpgroup 0 is the producer: one thread loads the Q tile once by TMA
//   and keeps 2-stage rings of K tiles and of V tiles (BK x DP each) in
//   flight, each tile completing on its own mbarrier. BK is 128 keys up to
//   DP = 128 and 64 above, where Q and two 128-key stages of K and V would
//   take 240 KB (DP = 192) or 320 KB (DP = 256) of shared memory; at 64
//   keys they take 144 and 192 KB. Its registers drop to 24 (setmaxnreg).
// - Warpgroups 1 and 2 are consumers with 240 registers, 64 q rows each:
//   S = Q K^T by wgmma SS m64nBKk16 (K a K-major B); the online softmax
//   on the accumulator fragment in f32, with scale and log2(e) folded into
//   one FFMA before ex2.approx, and the row max and sum reduced over the 4
//   threads of a quad; P rounded to v's type (:141) in registers, which
//   are the A operand of O += P V by wgmma RS (m64n128 and m64n64 pieces
//   over DP) with V an MN-major B. O holds DP / 2 f32 registers a thread.
//   Inside a consumer, S of tile j is issued with P V of tile j - 1 and
//   the softmax of tile j runs while P V is on the tensor cores (FA3's
//   intra-warpgroup overlap). K is released once S is done, V once P V is.
//   A consumer skips the k tiles that none of its rows sees.
// - Only the diagonal tiles and a ragged last k tile are masked: masked
//   positions carry the JAX package's NEG_INF = -1e30 in the max and
//   contribute p = 0. A row that sees no key gets o = 0 and lse = -1e30
//   (the l == 0 guards of :157-161). TMA's zero fill covers rows past Sq
//   and keys past Sk.
// - Epilogue: O / l rounded to bf16, staged in the consumer's own rows of
//   the Q tile and stored by TMA (clipped at Sq and d); lse by plain stores.
// - No atomics and a fixed order: runs repeat bit for bit.
// Backward, bf16, DP of 64 or 128 (`flash_bwd_wgmma`): the split dk/dv
// kernel of csrc/flash_attention_split.cu with dq added, on sm90.cuh.
// - One block per (b * Hkv, 128-key tile), the lowest keys (the longest
//   causal walks) first. Warpgroup 0 is the producer (24 registers): K and
//   V are loaded once by TMA; Q and dO stream in 64-row tiles through a
//   ring (2 stages at DP = 128, 4 at DP = 64) that walks the rep q heads of
//   the kv head, each from the causal clamp (`_clamp_qi` :227), with each
//   tile's lse (times log2(e)) and delta staged beside it.
// - Warpgroups 1 and 2 are consumers (240 registers) with 64 keys each.
//   Per q tile, transposed as FA3 does: S^T = K Q^T and dP^T = V dO^T by
//   SS wgmma, P^T (rounded to do's type, :415) and dS^T (rounded to q's
//   type, :422) in registers as the RS A operands of dV += P^T dO and
//   dK += dS^T Q.
// - dq (the fused extra, :425-428): each consumer writes its bf16 dS^T
//   rows into a shared [128 keys][64 q] tile (two, used in turn), and after
//   a named barrier computes a [64 q x 64] f32 product dQ = dS K by SS
//   wgmma, dS read MN-major from that tile and K MN-major from the
//   resident K tile. At DP = 128 consumer c takes columns 64c..64c+63 over
//   all 128 keys; at DP = 64 all columns over its own 64 keys. On the TPU
//   dq accumulated in VMEM scratch across the sequential grid; here blocks
//   run in no order, so the product, times scale, is staged in shared
//   memory (f32, 128-byte swizzled) and one thread adds it into the zeroed
//   [B*Hq, Sq, d] f32 workspace by a TMA reduce-add
//   (cp.reduce.async.bulk.tensor), clipped at Sq and d; the caller casts it
//   to q's type. No atomics from registers, but the order of the adds
//   across blocks changes from run to run, so two runs need not give the
//   same bits (the split pair does).
// - dK (scaled once) and dV leave through the consumer's rows of the K and
//   V tiles by TMA stores clipped at Sk and d.
// Backward, bf16, DP of 192 or 256: `flash_bwd_wide_wgmma<DP, true>`
// (csrc/flash_bwd_wide.cuh), whose consumers split dV (with dQ) and dK
// between them over 64-key blocks, since dK and dV of 64 keys at every
// column no longer fit one consumer's registers.
// f32: the column-chunked bodies of csrc/flash_f32.cuh, kept for the f32
// checks (dq there by f32 atomicAdd).
#include "flash_bwd_wide.cuh"
#include "flash_f32.cuh"
#include "sm90.cuh"

namespace {

// ----------------------------------------------- forward, bf16 (wgmma)
using flash_f32::kNegInf;
using flash_f32::quad_max;
using flash_f32::quad_sum;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP>
struct Fa3 {
  static constexpr int kBoxes = DP / 64;             // 64-column boxes
  static constexpr int kBK = DP <= 128 ? 128 : 64;   // keys per K/V tile
  static constexpr uint32_t kQBox = 128 * 128;       // [128 rows][64], 16 KB
  static constexpr uint32_t kKBox = kBK * 128;       // [kBK keys][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr uint32_t kKTile = kBoxes * kKBox;  // a K or V tile
  static constexpr int kStages = 2;                   // of K and of V
  static constexpr uint32_t kKOff = kQTile;
  static constexpr uint32_t kVOff = kKOff + kStages * kKTile;
  static constexpr uint32_t kBarOff = kVOff + kStages * kKTile;
  // barriers: K full/empty, V full/empty (kStages each), then Q
  static constexpr size_t kSmem = kBarOff + (4 * kStages + 1) * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

template <int DP, bool H>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap o_map,
                    float* __restrict__ lse, int rep, int sq, int sk,
                    float scale, int causal) {
  using L = Fa3<DP>;
  constexpr int S = L::kStages, BK = L::kBK;
  extern __shared__ __align__(1024) uint8_t tma_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tma_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t k_full = base + L::kBarOff, k_empty = k_full + 8 * S,
                 v_full = k_empty + 8 * S, v_empty = v_full + 8 * S,
                 q_bar = v_empty + 8 * S;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // longest tiles first
  const int offset = sk - sq;
  // keys visible to the tile's last row bound the walk (causal skip)
  int k_end = sk;
  if (causal) k_end = min(sk, min(q0 + 128, sq) + offset);
  const int n_kt = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(k_full + 8 * i, 1);
      sm90::mbar_init(v_full + 8 * i, 1);
      sm90::mbar_init(k_empty + 8 * i, 8);  // lane 0 of each consumer warp
      sm90::mbar_init(v_empty + 8 * i, 8);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    sm90::reg_dealloc<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_bar, L::kQTile);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_load_3d(base + b * L::kQBox, &q_map, q_bar, 64 * b, q0, bh);
      const int bhk = bh / rep;
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        const uint32_t par = ((j / S) & 1) ^ 1;
        sm90::mbar_wait(k_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(k_full + 8 * st, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kKOff + st * L::kKTile + b * L::kKBox,
                            &k_map, k_full + 8 * st, 64 * b, BK * j, bhk);
        sm90::mbar_wait(v_empty + 8 * st, par);
        sm90::mbar_arrive_expect_tx(v_full + 8 * st, L::kKTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          sm90::tma_load_3d(base + L::kVOff + st * L::kKTile + b * L::kKBox,
                            &v_map, v_full + 8 * st, 64 * b, BK * j, bhk);
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
      n_wg = max(0, min(sk, min(wq0 + 64, sq) + offset) + BK - 1) / BK;
    const float sl2 = scale * kLog2e;

    float o[DP / 2], s[BK / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    // running row max of s * scale * log2(e), and row sum of p
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    auto release = [&](uint32_t bar, int j) {
      if (lane == 0) sm90::mbar_arrive(bar + 8 * (j % S));
    };
    // issue S = Q K_j^T: 64 rows x BK keys, k over DP in steps of 16
    auto scores = [&](int j) {
      const uint32_t ks = base + L::kKOff + (j % S) * L::kKTile;
      sm90::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t qd = sm90::desc_b128(
            base + (kk / 4) * L::kQBox + c * 64 * 128 + col, 16, 1024);
        const uint64_t kd =
            sm90::desc_b128(ks + (kk / 4) * L::kKBox + col, 16, 1024);
        if constexpr (BK == 128)
          sm90::wgmma_ss_n128<0, H>(s, qd, kd, kk > 0);
        else
          sm90::wgmma_ss_n64<0, 0, H>(s, qd, kd, kk > 0);
      }
      sm90::wgmma_commit();
    };
    // issue O += P V_j: k over the BK keys in steps of 16, V MN-major
    auto pv = [&](int j) {
      const uint32_t vs = base + L::kVOff + (j % S) * L::kKTile;
      sm90::mbar_wait(v_full + 8 * (j % S), (j / S) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::rs_step<DP, H>(o, pa[kk], vs + kk * 16 * 128, L::kKBox);
      sm90::wgmma_commit();
    };
    // the online softmax of tile j on s: p (f32) into s, the new row max
    // into m, the rescale of the old sums into alpha, the row sums of p
    // into rs
    auto softmax = [&](int j, float(&alpha)[2], float(&rs)[2]) {
      const int k0 = BK * j;
      const bool masked =
          k0 + BK > sk || (causal && k0 + BK - 1 > wq0 + offset);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (masked) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = rows[(i >> 1) & 1];
          if (col >= sk || (causal && col > row + offset)) s[i] = kNegInf;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]) * sl2);
        alpha[h] = sm90::ex2_approx(m[h] - mn);
        m[h] = mn;
        rs[h] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        const float p = masked && s[i] == kNegInf
                            ? 0.f
                            : sm90::ex2_approx(fmaf(s[i], sl2, -m[h]));
        s[i] = p;
        rs[h] += p;
      }
    };
    // P rounded to v's type (:141): the A fragments of O += P V
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] =
              sm90::pack_x2<H>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    sm90::mbar_wait(q_bar, 0);
    if (n_wg > 0) {
      float alpha[2], rs[2];
      scores(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      release(k_empty, 0);
      softmax(0, alpha, rs);
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = quad_sum(rs[h]);
      pack_p();
      // S of tile j runs beside P V of tile j - 1; the softmax of tile j
      // runs while P V of tile j - 1 is still on the tensor cores
      for (int j = 1; j < n_wg; ++j) {
        scores(j);
        pv(j - 1);
        sm90::wgmma_wait<1>();
        sm90::fence_regs(s);
        release(k_empty, j);
        softmax(j, alpha, rs);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(pa);
        release(v_empty, j - 1);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
        pack_p();
      }
      pv(n_wg - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      release(v_empty, n_wg - 1);
    }
    for (int j = n_wg; j < n_kt; ++j) {  // tiles none of these rows sees
      sm90::mbar_wait(k_full + 8 * (j % S), (j / S) & 1);
      release(k_empty, j);
      sm90::mbar_wait(v_full + 8 * (j % S), (j / S) & 1);
      release(v_empty, j);
    }

    // epilogue: O / l into this consumer's rows of the Q tile, then TMA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ls = l[h] == 0.f ? 1.f : l[h];
      const float inv = 1.f / ls;
      if (t4 == 0 && rows[h] < sq)
        lse[(size_t)bh * sq + rows[h]] =
            l[h] == 0.f ? kNegInf : (m[h] + log2f(ls)) * kLn2;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i)
        if (((i >> 1) & 1) == h) o[i] *= inv;
    }
    sm90::stage_rows<DP, H>(smem, L::kQBox, o, 1.f, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        sm90::tma_store_3d(&o_map, base + b * L::kQBox + c * 64 * 128, 64 * b,
                           wq0, bh);
      sm90::tma_store_commit();
      sm90::tma_store_wait();
    }
  }
}

template <int DP, bool H>
cudaError_t launch_fwd_16bit(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bhq, int rep, int sq,
                            int sk, int d, float scale, int causal,
                            cudaStream_t stream) {
  using L = Fa3<DP>;
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, d, 128, H) ||
      !sm90_host::map_rows(&k_map, k, bhq / rep, sk, d, L::kBK, H) ||
      !sm90_host::map_rows(&v_map, v, bhq / rep, sk, d, L::kBK, H) ||
      !sm90_host::map_rows(&o_map, o, bhq, sq, d, 64, H))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhq, (sq + 127) / 128);
  flash_fwd_wgmma<DP, H><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, o_map, (float*)lse, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------ fused backward, bf16 (wgmma)
template <int D>
struct BwdWg {
  static_assert(D == 64 || D == 128, "wider tiles: flash_bwd_wide.cuh");
  static constexpr int kBoxes = D / 64;              // 64-column boxes
  static constexpr uint32_t kKBox = 128 * 128;       // [128 keys][64]
  static constexpr uint32_t kKTile = kBoxes * kKBox;
  static constexpr uint32_t kQBox = 64 * 128;        // [64 q rows][64]
  static constexpr uint32_t kQTile = kBoxes * kQBox;
  static constexpr int kStages = D == 128 ? 2 : 4;   // of Q, dO and rows
  static constexpr uint32_t kDsTile = 128 * 128;     // dS^T [128 keys][64 q]
  static constexpr uint32_t kDqBox = 64 * 128;       // [64 q rows][32] f32
  static constexpr uint32_t kVOff = kKTile;
  static constexpr uint32_t kQOff = 2 * kKTile;
  static constexpr uint32_t kDoOff = kQOff + kStages * kQTile;
  static constexpr uint32_t kDsOff = kDoOff + kStages * kQTile;  // 2 tiles
  static constexpr uint32_t kDqOff = kDsOff + 2 * kDsTile;  // 2 boxes each
  // per stage: 64 lse * log2(e), then 64 delta (f32)
  static constexpr uint32_t kRowOff = kDqOff + 2 * 2 * kDqBox;
  static constexpr uint32_t kBarOff = kRowOff + kStages * 512;
  // barriers: full/empty (kStages each), then K and V
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 1) * 8 + 1024;
};

template <int D, bool H>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const __grid_constant__ CUtensorMap dk_map,
                    const __grid_constant__ CUtensorMap dv_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int rep, int sq, int sk,
                    float scale, int causal) {
  using L = BwdWg<D>;
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
    // dQ of a q tile = dS K, 64 columns a consumer: at D = 128 consumer c
    // takes columns 64c.. over all 128 keys (it reads the other's dS^T
    // rows); at D = 64 every column over its own 64 keys (both add into the
    // same rows). Either way a [64 x 64] f32 product.
    constexpr int kDqSteps = D == 128 ? 8 : 4;       // k16 steps over keys
    const int dq_key0 = D == 128 ? 0 : 64 * c;
    const int dq_col = D == 128 ? 64 * c : 0;
    const uint32_t dq_b = base + (D == 128 ? c * L::kKBox : 0) + dq_key0 * 128;
    // the dS^T tiles are shared by both consumers at D = 128
    const int ds_bar = D == 128 ? 3 : 1 + c, ds_threads = D == 128 ? 256 : 128;
    uint8_t* stage = smem + L::kDqOff + c * 2 * L::kDqBox;

    float dk[D / 2], dv[D / 2], s[32], dp[32], dq[32];
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    sm90::mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_items; ++it) {
      const int st = it % S;
      const int bh = bhk * rep + it / n_qt;
      const int q0 = q_begin + (it % n_qt) * 64;
      const uint32_t qs = base + L::kQOff + st * L::kQTile;
      const uint32_t dos = base + L::kDoOff + st * L::kQTile;
      sm90::mbar_wait(full + 8 * st, (it / S) & 1);
      // some key of this consumer is seen from the tile (and lies before Sk)
      const bool active = kc0 < sk && (!causal || kc0 <= q0 + 63 + offset);
      if (active) {
        const float* rows =
            reinterpret_cast<const float*>(smem + L::kRowOff + st * 512);
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;  // not carried
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
        // P^T rounded to do's type (:415), dS^T to q's type (:422) and so
        // to k's type for dQ (:428; the two types are the same here)
        sm90::pack_frags<H>(pa, s);
        sm90::pack_frags<H>(dsa, dp);
        sm90::wgmma_fence();
        sm90::rs_k64<D, H>(dv, pa, dos, L::kQBox);  // dV += P^T dO, dO MN-major
        sm90::rs_k64<D, H>(dk, dsa, qs, L::kQBox);  // dK += dS^T Q, Q MN-major
        sm90::wgmma_commit();
      }
      // this consumer's 64 rows of the item's dS^T tile (zero where none of
      // its keys is seen); the tile of item it - 2 is free: both consumers
      // finished its dQ products before the dS^T barrier of item it - 1
      uint8_t* ds_tile = smem + L::kDsOff + (it & 1) * L::kDsTile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 64 * c + 16 * warp + g + 8 * (r & 1);
          const int chunk = (2 * kk + (r >> 1)) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(ds_tile + row * 128 + chunk * 16 +
                                       4 * t4) = active ? dsa[kk][r] : 0u;
        }
      sm90::fence_proxy_async();
      // the previous item's dQ reduce has read this consumer's staging
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_bar_sync(ds_bar, ds_threads);
      // at D = 64 a consumer whose keys are unseen adds nothing to dQ
      const bool do_dq = D == 128 || active;
      if (do_dq) {
        const uint32_t ds_a = sm90::smem_addr(ds_tile) + dq_key0 * 128;
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;  // not carried
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqSteps; ++kk)  // dS read MN-major (q rows)
          sm90::wgmma_ss_n64<1, 1, H>(
              dq, sm90::desc_b128(ds_a + kk * 16 * 128, L::kDsTile, 1024),
              sm90::desc_b128(dq_b + kk * 16 * 128, L::kKBox, 1024), 1);
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(dsa);
      if (lane == 0) sm90::mbar_arrive(empty + 8 * st);
      if (do_dq) {
        // scale * dQ (each tile's product scaled, :428) into the staging:
        // two [64 rows][32] f32 boxes, 128-byte swizzled; then one
        // reduce-add per box into the f32 workspace, clipped at Sq
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * warp + g + 8 * h;
            const int chunk = (2 * (j & 3) + (t4 >> 1)) ^ (row & 7);
            *reinterpret_cast<float2*>(stage + (j >> 2) * L::kDqBox +
                                       row * 128 + chunk * 16 +
                                       8 * (t4 & 1)) =
                make_float2(dq[4 * j + 2 * h] * scale,
                            dq[4 * j + 2 * h + 1] * scale);
          }
        sm90::fence_proxy_async();
        sm90::named_bar_sync(1 + c, 128);
        if (tid == 0) {
          const uint32_t src = sm90::smem_addr(stage);
          sm90::tma_reduce_add_3d(&dq_map, src, dq_col, q0, bh);
          sm90::tma_reduce_add_3d(&dq_map, src + L::kDqBox, dq_col + 32, q0,
                                  bh);
          sm90::tma_store_commit();
        }
      }
    }

    // epilogue: scale * dK and dV into this consumer's rows of the K and V
    // tiles, then TMA (clipped at Sk). At D = 128 the other consumer's last
    // dQ product reads every K row: wait for it.
    if (D == 128) sm90::named_bar_sync(3, 256);
    sm90::stage_rows<D, H>(smem, L::kKBox, dk, scale, c, warp, g, t4);
    sm90::stage_rows<D, H>(smem + L::kVOff, L::kKBox, dv, 1.f, c, warp, g, t4);
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + c, 128);
    if (tid == 0) {
      if (kc0 < sk) {
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          sm90::tma_store_3d(&dk_map, k_rows + b * L::kKBox, 64 * b, kc0,
                             bhk);
          sm90::tma_store_3d(&dv_map, v_rows + b * L::kKBox, 64 * b, kc0,
                             bhk);
        }
        sm90::tma_store_commit();
      }
      sm90::tma_store_wait();  // the stores and the dQ reduce-adds
    }
  }
}

template <int D, bool H>
cudaError_t launch_bwd_16bit(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq_acc, void* dk,
                            void* dv, int bhk, int rep, int sq, int sk, int d,
                            float scale, int causal, cudaStream_t stream) {
  using L = BwdWg<D>;
  const int bhq = bhk * rep;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map;
  if (!sm90_host::map_rows(&q_map, q, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&do_map, dout, bhq, sq, d, 64, H) ||
      !sm90_host::map_rows(&k_map, k, bhk, sk, d, 128, H) ||
      !sm90_host::map_rows(&v_map, v, bhk, sk, d, 128, H) ||
      !sm90_host::map_rows_f32(&dq_map, dq_acc, bhq, sq, d, 64) ||
      !sm90_host::map_rows(&dk_map, dk, bhk, sk, d, 64, H) ||
      !sm90_host::map_rows(&dv_map, dv, bhk, sk, d, 64, H))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_wgmma<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bhk, (sk + 127) / 128);
  flash_bwd_wgmma<D, H><<<grid, 384, L::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map,
      (const float*)lse, (const float*)delta, rep, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q/o [bhq, sq, d], k/v
// [bhq/rep, sk, d], lse [bhq, sq] f32, d <= 256 a multiple of 4 (f32) or 8
// (bf16, f16). Returns
// the CUDA error of the launch (0 on success; cudaErrorInvalidValue for
// shapes the kernel does not take).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bhq, int rep, int sq, int sk,
                                          int head_dim, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  if (!flash_shape_ok(bhq, rep, sq, sk, head_dim, dtype) || bhq % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(head_dim, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    if (dtype == 0)
      return flash_f32::launch_fwd<DP>(q, k, v, o, lse, bhq, rep, sq, sk,
                                       head_dim, scale, causal, s);
    return dtype == 2
               ? launch_fwd_16bit<DP, true>(q, k, v, o, lse, bhq, rep, sq,
                                            sk, head_dim, scale, causal, s)
               : launch_fwd_16bit<DP, false>(q, k, v, o, lse, bhq, rep, sq,
                                             sk, head_dim, scale, causal, s);
  });
}

// dq_acc [bhk*rep, sq, d] f32 must be zero on entry; dk/dv [bhk, sk, d].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
    int bhk, int rep, int sq, int sk, int head_dim, float scale, int causal,
    int dtype, void* stream) {
  if (!flash_shape_ok(bhk, rep, sq, sk, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(head_dim, [&](auto w) {
    constexpr int DP = decltype(w)::value;
    if (dtype == 0)
      return flash_f32::launch_bwd_kv<DP, true>(
          q, k, v, dout, lse, delta, dq_acc, dk, dv, bhk, rep, sq, sk,
          head_dim, scale, causal, s);
    auto run = [&](auto h) {
      constexpr bool H = decltype(h)::value;
      if constexpr (DP <= 128)
        return launch_bwd_16bit<DP, H>(q, k, v, dout, lse, delta, dq_acc, dk,
                                       dv, bhk, rep, sq, sk, head_dim, scale,
                                       causal, s);
      else
        return flash_wide::launch<DP, true, H>(
            q, k, v, dout, lse, delta, dq_acc, dk, dv, bhk, rep, sq, sk,
            head_dim, scale, causal, s);
    };
    return dtype == 2 ? run(std::true_type{}) : run(std::false_type{});
  });
}
