// Flash attention forward for Hopper (sm_90a): causal / sliding window / GQA,
// bf16 or f32, with a plain C interface (loaded from Python with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_tpu
// (Pallas, body `_kernel`) and computes the same function:
//   q (BH, Sq, hd), k/v (BKV, Sk, hd), BH = BKV * G; q head bh reads kv head bh / G.
//   mask: kpos < Sk; causal kpos <= qpos (top-left aligned, both from 0);
//         window qpos - kpos < window.
//   Running max / sum / accumulator in f32; p is rounded to v's type before
//   P.V; out = acc / max(l, 1e-37) in q's type (the bf16 kernel multiplies by
//   the reciprocal, within 2 f32 ulps of it). Masked probabilities are
//   exactly 0, so a row that has seen no valid key yet carries l = 0,
//   acc = 0 (a row with no valid key at all comes out 0; the wrapper
//   refuses such calls).
//   Optionally also lse (BH, Sq) f32, the row's logsumexp of the scaled
//   scores, m + log(l) from the softmax statistics the epilogue holds anyway
//   (the backward, flash_attention_bwd.cu, recomputes P from it). Serving
//   passes a null pointer; o is the same either way.
//
// What bounds it: at the serving shapes (hd 256, S 2048, causal or a window
// of 1024 or 2048, GQA 2 or 16) a launch does 5e10-1.4e11 FLOP of Q.K^T and
// P.V against 50-130 MB of q/k/v/o, far above the H100's ~295 FLOP/byte
// balance point, so the bf16 tensor cores bound it (989 TFLOP/s dense);
// only wgmma reaches that rate. Inside an SM, shared memory comes close to
// binding too: a 128-row x 64-key step reads Q and K (both warpgroups) and V
// out of shared memory and writes K and V into it, 256 KB, about as many
// cycles at 128 B/cycle as the step's wgmmas take at the peak rate.
//
// bf16 (the served path): one kernel, flash_fwd_bf16_kernel, for every head
// dim. What the design does about the bound:
//   * a persistent block of 3 warpgroups per SM walks the (bh, 128-row q
//     tile) work, heaviest causal tiles first, in a snake that evens out the
//     blocks' causal costs; a loop over 64-key kv tiles replaces the TPU's
//     sequential kv grid axis;
//   * a producer warpgroup, of which one thread issues TMA loads: each
//     tile's Q once, K and V tiles into a 2-stage ring guarded by full/empty
//     mbarriers (K and V on barriers of their own, so that V lands while
//     Q.K^T runs), and the next tile's Q and K/V as soon as the consumers
//     release them, so loads overlap the end of the previous tile. 3-D
//     tensor maps over (heads, S, hd) zero-fill rows past S, so ragged
//     edges need no copies and never read the next head; tiles carry the
//     swizzle that the wgmma descriptors name (128 B, or 64 / 32 B where a
//     row is narrower), so shared-memory reads are conflict-free;
//   * two consumer warpgroups of 64 q rows each, given 240 registers by
//     setmaxnreg (the producer keeps 24): S = Q.K^T by wgmma m64n64k16 from
//     shared memory; the f32 S accumulator, rounded to bf16 in registers, is
//     the A operand of O += P.V (wgmma m64n{hd}k16, V read MN-major through
//     the transpose flag, so no transposed copy). Tile i's Q.K^T and tile
//     i-1's P.V are issued together, and the softmax of tile i runs while
//     that P.V is on the tensor cores;
//   * softmax in exp2, with scale * log2(e) folded into the one FFMA that
//     feeds it; O (128 registers a thread at hd 256) is rescaled only when a
//     row max grows by more than 2^8, and barriers are released once per
//     warp, which took the softmax off the critical path;
//   * the epilogue scales O by 1 / l, stages it in the consumer's own Q
//     buffer with the tensor map's swizzle and writes it with TMA stores,
//     which drop rows past Sq (the divisions and 4-byte stores it replaces
//     took a tenth of the kernel); the Q buffer goes back to the producer
//     once the store has read it;
//   * kv tiles that are fully masked are skipped (a windowed q tile reads at
//     most window + 128 keys); only diagonal and edge tiles evaluate the mask.
// Not yet: fewer shared-memory reads of Q per FLOP (more than 64 keys per
// Q.K^T wgmma; 80 keys measured no faster, and Q in registers needs 64 more
// registers a thread than the 240 left beside O at hd 256).
//
// f32 (the 2e-5 reference checks, on no served path): flash_fwd_f32_kernel,
// 4 warps per (bh, 64-row q tile), synchronous tile loads into padded shared
// memory and scalar FMAs; TF32 products would break the 2e-5 tolerance.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;

// ---------------------------------------------------------------------------
// bf16: TMA ring, producer warpgroup, two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BM = 128;          // q rows per block
constexpr int BN = 64;           // keys per kv tile
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup
constexpr int CONSUMERS = BM / WG_ROWS;
constexpr int STAGES = 2;        // kv ring depth
constexpr float RESCALE = 8.f;   // log2 of how far p may exceed 1 before m moves
constexpr int BF16_THREADS = (CONSUMERS + 1) * 128;

// Shared-memory layout of one block at head dim HD. Every 64-row tile (a
// consumer's Q, a stage's K or V) is NB boxes of 64 rows x SW bytes, box b
// holding columns [b*BC, (b+1)*BC), swizzled in 8-row atoms of 8*SW bytes.
template <int HD>
struct Smem : Swizzle<HD> {                                 // SW, BC, NB, MODE
  static constexpr int BOX = 64 * Swizzle<HD>::SW;
  static constexpr int TILE = Swizzle<HD>::NB * BOX;        // 64 * HD * 2
  static constexpr int Q = 0;
  static constexpr int K = Q + CONSUMERS * TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  // barriers: fullQ, emptyQ [CONSUMERS]; fullK, fullV, emptyK, emptyV [STAGES]
  static constexpr int BYTES = BAR + 8 * (2 * CONSUMERS + 4 * STAGES) + 1024;   // + alignment slack
};

// Issue S = Q K^T (64 x 64) for one consumer warpgroup, both operands K-major
// in shared memory, as one wgmma group.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_tile, uint32_t k_tile) {
  using L = Smem<HD>;
  // descriptors of k-step 0; k-step kk adds its byte offset / 16. The empty
  // asm hides q_desc's invariance, so that the compiler builds each k-step's
  // descriptor where it is used instead of keeping all of them live.
  uint64_t q_desc = smem_desc(q_tile, 16, 8 * L::SW, L::MODE);
  asm volatile("" : "+l"(q_desc));
  const uint64_t k_desc = smem_desc(k_tile, 16, 8 * L::SW, L::MODE);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = ((kk / (L::BC / 16)) * L::BOX + (kk % (L::BC / 16)) * 32) >> 4;
    if (kk == 0)
      wgmma_ss_n64<false>(sc, q_desc, k_desc);
    else
      wgmma_ss_n64<true>(sc, q_desc + off, k_desc + off);
  }
  wgmma_commit();
}

// Issue O += P V as one wgmma group: P (bf16) from registers, V MN-major in
// shared memory (the transpose flag).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_tile) {
  using L = Smem<HD>;
  const uint64_t v_desc = smem_desc(v_tile, L::BOX, 8 * L::SW, L::MODE);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wgmma_rs<HD>(acc, pa[j], v_desc + ((j * 16 * L::SW) >> 4));
  wgmma_commit();
}

// Online softmax of one 64-key score tile of a consumer warp, in place: sc
// becomes p. Rows: row0 (e = 0, 1) and row0 + 8 (e = 2, 3); sc[4n + e]
// holds key k0 + 8n + 2t + (e & 1) (the wgmma accumulator layout, per warp
// the m16n8 one). Scores are sc * c with c = |scale * log2(e)| (a negative
// scale flips sc first), so that the row max of sc is that of the scores.
// The reference subtracts the running row max m before exp; any m gives the
// same out = sum p v / sum p, so m moves only when a tile's max passes it by
// more than RESCALE (p then stays <= 2^RESCALE, and bf16 rounds p to the same
// relative precision at any size). Returns whether O must be multiplied by
// alpha, true for the whole warp when some row of it moved.
__device__ __forceinline__ bool softmax_tile(float (&sc)[BN / 2], float (&alpha)[2],
                                             float (&m_run)[2], float (&l_run)[2], bool edge,
                                             int row0, int k0, int t, int Sk, int causal,
                                             int window, float scale_log2) {
  if (scale_log2 < 0.f) {
#pragma unroll
    for (int n = 0; n < BN / 2; ++n) sc[n] = -sc[n];
  }
  const float c = fabsf(scale_log2);
  uint32_t valid = ~0u;   // bit 4n + e: the mask keeps sc[4n + e]
  if (edge) {
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e >> 1) * 8, kp = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        if (!ok) {
          sc[4 * n + e] = NEG_INF;
          valid &= ~(1u << (4 * n + e));
        }
      }
  }
  float mx[2] = {NEG_INF, NEG_INF};   // the tile's row maxima, unscaled
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
  bool grow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    grow[r] = mx[r] != NEG_INF && (m_run[r] == NEG_INF || mx[r] * c > m_run[r] + RESCALE);
  }
  const bool rescale = __any_sync(0xffffffffu, grow[0] || grow[1]);
  if (rescale) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = grow[r] ? mx[r] * c : m_run[r];
      alpha[r] = fast_exp2(m_run[r] - m_new);   // 0 from m = NEG_INF, 1 if unmoved
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
  }
  // masked probabilities are exactly 0 (a row with no valid key yet keeps
  // m = NEG_INF and subtracts 0 instead)
  const float neg_m[2] = {m_run[0] == NEG_INF ? 0.f : -m_run[0],
                          m_run[1] == NEG_INF ? 0.f : -m_run[1]};
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(sc[4 * n + e], c, neg_m[e >> 1]));
      if (edge) p = (valid >> (4 * n + e)) & 1u ? p : 0.f;
      l_run[e >> 1] += p;
      sc[4 * n + e] = p;
    }
  return rescale;
}

// P in bf16 as the wgmma A fragments of keys 16j..16j+15: the accumulator
// of key columns 2j and 2j + 1 is that fragment (the m16n8k16 A layout).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      pa[n / 2][(n % 2) * 2 + (e >> 1)] = pack_bf16x2(sc[4 * n + e], sc[4 * n + e + 1]);
}

template <int HD>
__device__ __forceinline__ void scale_o(float (&acc)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
}

// The block's q tiles: a persistent block per SM walks the BH * nq tiles,
// ordered heaviest first (the last q tile of every head, then the one
// before, ...), in a snake: round r gives block b rank r * grid + b for even
// r and r * grid + grid - 1 - b for odd r, which evens out the causal costs.
struct Tiles {
  int BH, nq, n;
  __device__ __forceinline__ bool get(int round, int& bh, int& q0) const {
    const int b = (round & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int rank = round * gridDim.x + b;
    if (rank >= n) return false;
    bh = rank % BH;
    q0 = (nq - 1 - rank / BH) * BM;
    return true;
  }
};

// kv tiles [t0, t0 + n) that rows [r0, r1) see
__device__ __forceinline__ void kv_tiles(int r0, int r1, int Sk, int causal, int window, int& t0,
                                         int& n) {
  const int kb = window > 0 ? max(0, r0 - window + 1) : 0;
  const int ke = causal ? min(Sk, r1) : Sk;
  t0 = kb / BN;
  n = max(0, (ke + BN - 1) / BN - t0);
}

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_fwd_bf16_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                      __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap to,
                      float* __restrict__ lse, int BH, int G,
                      int Sq, int Sk, int causal, int window, float scale_log2) {
  using L = Smem<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1024 B
  const uint32_t bar = base + L::BAR;
  const uint32_t fullQ = bar, emptyQ = fullQ + 8 * CONSUMERS, fullK = emptyQ + 8 * CONSUMERS,
                 fullV = fullK + 8 * STAGES, emptyK = fullV + 8 * STAGES,
                 emptyV = emptyK + 8 * STAGES;
  const Tiles tiles{BH, (Sq + BM - 1) / BM, BH * ((Sq + BM - 1) / BM)};

  if (threadIdx.x == 0) {
    for (int c = 0; c < CONSUMERS; ++c) {
      mbar_init(fullQ + 8 * c, 1);
      mbar_init(emptyQ + 8 * c, 1);                  // consumer c's O store has read its Q buffer
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(fullV + 8 * s, 1);
      mbar_init(emptyK + 8 * s, CONSUMERS * 4);      // one arrival per consumer warp
      mbar_init(emptyV + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that the compiler knows it
  // is warp-uniform: only then does it compile each role's branch with the
  // register count that role's setmaxnreg sets
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;                                     // kv ring uses so far
      int nq_loaded[CONSUMERS] = {};                  // Q loads per consumer so far
      int bh, q0;
      for (int round = 0; tiles.get(round, bh, q0); ++round) {
        const int kvh = bh / G;
        int t0, n;
        kv_tiles(q0, min(Sq, q0 + BM), Sk, causal, window, t0, n);
#pragma unroll
        for (int c = 0; c < CONSUMERS; ++c) {
          if (q0 + c * WG_ROWS >= Sq) continue;        // that warpgroup has no rows
          if (nq_loaded[c] > 0) mbar_wait(emptyQ + 8 * c, (nq_loaded[c] - 1) & 1);
          mbar_expect_tx(fullQ + 8 * c, L::TILE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
            tma_load_3d(base + L::Q + c * L::TILE + b * L::BOX, &tq, fullQ + 8 * c, b * L::BC,
                        q0 + c * WG_ROWS, bh);
          ++nq_loaded[c];
        }
        for (int i = 0; i < n; ++i, ++it) {
          const int s = it % STAGES, k0 = (t0 + i) * BN;
          const uint32_t parity = ((it / STAGES) & 1) ^ 1;   // the stage's previous use
          if (it >= STAGES) mbar_wait(emptyK + 8 * s, parity);
          mbar_expect_tx(fullK + 8 * s, L::TILE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
            tma_load_3d(base + L::K + s * L::TILE + b * L::BOX, &tk, fullK + 8 * s, b * L::BC, k0, kvh);
          if (it >= STAGES) mbar_wait(emptyV + 8 * s, parity);
          mbar_expect_tx(fullV + 8 * s, L::TILE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
            tma_load_3d(base + L::V + s * L::TILE + b * L::BOX, &tv, fullV + 8 * s, b * L::BC, k0, kvh);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows [r0, r0 + 64) of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = base + L::Q + wg * L::TILE;
    auto pass = [&](int it) {   // a ring slot this warpgroup's rows do not need
      const int s = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      mbar_wait(fullK + 8 * s, parity);
      if (lane == 0) mbar_arrive(emptyK + 8 * s);
      mbar_wait(fullV + 8 * s, parity);
      if (lane == 0) mbar_arrive(emptyV + 8 * s);
    };
    int it = 0, nq_used = 0;
    int bh, q0;
    for (int round = 0; tiles.get(round, bh, q0); ++round) {
      const int r0 = q0 + wg * WG_ROWS;
      const bool active = r0 < Sq;
      const int row0 = r0 + warp * 16 + g;               // rows of e = 0, 1; +8 for e = 2, 3
      int t0, n;
      kv_tiles(q0, min(Sq, q0 + BM), Sk, causal, window, t0, n);
      // this warpgroup's kv tiles [wa, wb) of the block's [0, n): the others
      // it only waits for and releases, so that the ring's counts stay whole
      int wa = 0, wb = 0;
      if (active) {
        int wt0, wn;
        kv_tiles(r0, r0 + WG_ROWS, Sk, causal, window, wt0, wn);
        wa = min(n, wt0 - t0);
        wb = max(wa, min(n, wt0 - t0 + wn));
      }
      auto edge = [&](int k0) {   // does the mask cut into this 64 x 64 tile?
        return k0 + BN > Sk || (causal && k0 + BN - 1 > r0) ||
               (window > 0 && r0 + WG_ROWS - 1 - k0 >= window);
      };

      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m_run[2] = {NEG_INF, NEG_INF};
      float l_run[2] = {0.f, 0.f};                        // per-thread partial sums

      if (active) mbar_wait(fullQ + 8 * wg, nq_used & 1);
      for (int i = 0; i < wa; ++i) pass(it + i);
      if (wa < wb) {
        uint32_t pa[BN / 16][4];
        float alpha[2];
        bool rescale;
        {  // first tile: S, then P (O is still 0)
          const int s = (it + wa) % STAGES, k0 = (t0 + wa) * BN;
          float sc[BN / 2];
          mbar_wait(fullK + 8 * s, ((it + wa) / STAGES) & 1);
          wgmma_fence();
          issue_qk<HD>(sc, q_tile, base + L::K + s * L::TILE);
          wgmma_wait<0>();
          pin(sc);
          if (lane == 0) mbar_arrive(emptyK + 8 * s);
          softmax_tile(sc, alpha, m_run, l_run, edge(k0), row0, k0, t, Sk, causal, window,
                       scale_log2);
          pack_p(pa, sc);
          rescale = false;
        }
        // Steady state, tile i: S_i = Q K_i^T and O += P_{i-1} V_{i-1} run on
        // the tensor cores while this warpgroup does the softmax of S_i.
        for (int i = wa + 1; i < wb; ++i) {
          const int s = (it + i) % STAGES, sp = (it + i - 1) % STAGES, k0 = (t0 + i) * BN;
          float sc[BN / 2];
          mbar_wait(fullK + 8 * s, ((it + i) / STAGES) & 1);
          wgmma_fence();
          issue_qk<HD>(sc, q_tile, base + L::K + s * L::TILE);
          if (rescale) scale_o<HD>(acc, alpha);       // O to P_{i-1}'s max
          mbar_wait(fullV + 8 * sp, ((it + i - 1) / STAGES) & 1);
          pin(acc);
          pin(pa);
          wgmma_fence();
          issue_pv<HD>(acc, pa, base + L::V + sp * L::TILE);
          wgmma_wait<1>();                                 // S_i is in
          pin(sc);
          if (lane == 0) mbar_arrive(emptyK + 8 * s);
          rescale = softmax_tile(sc, alpha, m_run, l_run, edge(k0), row0, k0, t, Sk, causal,
                                 window, scale_log2);
          wgmma_wait<0>();                                 // P_{i-1} V_{i-1} is in
          pin(acc);
          pin(pa);
          if (lane == 0) mbar_arrive(emptyV + 8 * sp);
          pack_p(pa, sc);
        }
        // the last tile's P.V
        const int sl = (it + wb - 1) % STAGES;
        if (rescale) scale_o<HD>(acc, alpha);
        mbar_wait(fullV + 8 * sl, ((it + wb - 1) / STAGES) & 1);
        pin(acc);
        pin(pa);
        wgmma_fence();
        issue_pv<HD>(acc, pa, base + L::V + sl * L::TILE);
        wgmma_wait<0>();
        pin(acc);
        if (lane == 0) mbar_arrive(emptyV + 8 * sl);
      }
      for (int i = wb; i < n; ++i) pass(it + i);
      it += n;

      // ---- out = acc / max(l, 1e-37): staged in this warpgroup's Q buffer
      // with the tensor map's swizzle, then stored by TMA ----
      if (active) {
        ++nq_used;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
          l_run[r] = fmaxf(l_run[r], 1e-37f);
        }
        // lse = ln 2 (m + log2 l): m and the exponents are in log2 units
        if (lse != nullptr && t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r;
            if (row < Sq)
              lse[(size_t)bh * Sq + row] = (m_run[r] + log2f(l_run[r])) * 0.69314718055994531f;
          }
        }
        // The swizzle XORs a box row's 16-byte chunk index with x, bits 7 and
        // up of the row's offset; box b of column chunk j sits b * BOX further.
        unsigned char* qs = smem_raw + (q_tile - smem_u32(smem_raw));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float inv = 1.f / l_run[r];
          const int row = warp * 16 + g + 8 * r;      // within the warpgroup's 64
          const uint32_t x = ((row * L::SW) >> 7) & (L::SW / 16 - 1);
          unsigned char* rp = qs + row * L::SW + 4 * t;
#pragma unroll
          for (int j = 0; j < L::BC / 8; ++j) {
            unsigned char* cp = rp + ((j ^ x) << 4);
#pragma unroll
            for (int b = 0; b < L::NB; ++b) {
              const int n8 = b * (L::BC / 8) + j;     // columns 8 n8 + 2t, + 1
              *reinterpret_cast<uint32_t*>(cp + b * L::BOX) =
                  pack_bf16x2(acc[4 * n8 + 2 * r] * inv, acc[4 * n8 + 2 * r + 1] * inv);
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        if (threadIdx.x % 128 == 0) {
#pragma unroll
          for (int b = 0; b < L::NB; ++b) tma_store_3d(&to, q_tile + b * L::BOX, b * L::BC, r0, bh);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(emptyQ + 8 * wg);
        }
      }
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}


template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int BKV,
                        int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if ((err = tensor_map<HD>(encode, &tq, q, Sq, BH, 64)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &tk, k, Sk, BKV, 64)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &tv, v, Sk, BKV, 64)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &to, o, Sq, BH, 64)) != cudaSuccess) return err;
  const int smem = Smem<HD>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long work = (long long)BH * ((Sq + BM - 1) / BM);   // q tiles, one block per SM
  flash_fwd_bf16_kernel<HD><<<(unsigned)(work < sms ? work : sms), BF16_THREADS, smem, stream>>>(
      tq, tk, tv, to, lse, BH, BH / BKV, Sq, Sk, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, for the tight-tolerance checks
// ---------------------------------------------------------------------------

constexpr int F32_BM = 64;            // q rows per block, 16 per warp
constexpr int F32_WARPS = F32_BM / 16;
constexpr int F32_THREADS = F32_WARPS * 32;

template <int HD>
__host__ __device__ constexpr int f32_ld() { return HD + 4; }   // 16-byte row padding

template <int HD>
constexpr size_t f32_smem_bytes() {
  // q, k, v tiles and P staged per warp
  return (size_t)(F32_BM + 2 * BN) * f32_ld<HD>() * sizeof(float) +
         (size_t)F32_WARPS * 16 * BN * sizeof(float);
}

// Copy `nrows` rows of a (rows, HD) row-major tile into padded shared memory;
// rows at or past `valid` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int valid, int nrows) {
  constexpr int CPR = HD / 4;
  for (int c = threadIdx.x; c < nrows * CPR; c += F32_THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(src + (size_t)r * HD + col);
    *reinterpret_cast<float4*>(dst + r * f32_ld<HD>() + col) = val;
  }
}

// Fragment ownership (the m16n8 accumulator layout): lane = 4*g + t; in
// every 16x8 tile the thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3),
// columns 2t + (e & 1).
template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int G, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = f32_ld<HD>();
  constexpr int NT = BN / 8;                      // 8-key column tiles of S
  constexpr int OT = HD / 8;                      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + F32_BM * LD;
  float* Vs = Ks + BN * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_BM;   // heaviest tiles first
  const int bh = blockIdx.x;
  const float* qb = q + ((size_t)bh * Sq + q0) * HD;
  const float* kb = k + (size_t)(bh / G) * Sk * HD;
  const float* vb = v + (size_t)(bh / G) * Sk * HD;

  load_tile_f32<HD>(Qs, qb, Sq - q0, F32_BM);

  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + F32_BM);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int row0 = q0 + warp * 16 + g;            // rows of e = 0, 1; +8 for e = 2, 3

  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};                    // per-thread partial sums

  for (int k0 = (k_begin / BN) * BN; k0 < k_end; k0 += BN) {
    __syncthreads();                              // previous tile fully read
    load_tile_f32<HD>(Ks, kb + (size_t)k0 * HD, Sk - k0, BN);
    load_tile_f32<HD>(Vs, vb + (size_t)k0 * HD, Sk - k0, BN);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys ----
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* qr = Qs + (warp * 16 + g + (e >> 1) * 8) * LD;
        const float* kr = Ks + (n * 8 + 2 * t + (e & 1)) * LD;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        s[n][e] = dot;
      }

    // ---- mask, online softmax ----
    uint32_t valid = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e >> 1) * 8;
        const int kp = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        s[n][e] = ok ? s[n][e] * scale : NEG_INF;
        valid |= (uint32_t)ok << (n * 4 + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (valid >> (n * 4 + e)) & 1u ? expf(s[n][e] - m_run[e >> 1]) : 0.f;
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < OT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // ---- acc += P V ----
    float* ps = Vs + BN * LD + warp * 16 * BN;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[(g + (e >> 1) * 8) * BN + n * 8 + 2 * t + (e & 1)] = s[n][e];
    __syncwarp();
#pragma unroll
    for (int n = 0; n < OT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = ps + (g + (e >> 1) * 8) * BN;
        const float* vc = Vs + n * 8 + 2 * t + (e & 1);
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < BN; ++j) dot = fmaf(pr[j], vc[j * LD], dot);
        acc[n][e] += dot;
      }
    __syncwarp();
  }

  // ---- out = acc / max(l, 1e-37) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-37f);
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp < Sq) lse[(size_t)bh * Sq + qp] = m_run[r] + logf(l_run[r]);
    }
  }
  float* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = row0 + (e >> 1) * 8;
      if (qp < Sq) ob[(size_t)qp * HD + n * 8 + 2 * t + (e & 1)] = acc[n][e] / l_run[e >> 1];
    }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int BKV,
                       int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (Sq + F32_BM - 1) / F32_BM);
  flash_fwd_f32_kernel<HD><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, BH / BKV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse,
                   int BH, int BKV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t s) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s)
                 : launch_f32<HD>(q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
}

}  // namespace

extern "C" {

// q (BH, Sq, hd), k/v (BKV, Sk, hd), o (BH, Sq, hd), all contiguous and
// 16-byte aligned on the current device. is_bf16: 1 for bf16, 0 for f32.
// lse: null, or (BH, Sq) f32 for the rows' logsumexp (both paths write it).
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (or the error of building the bf16 path's tensor maps).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int BH, int BKV, int Sq, int Sk, int hd, int is_bf16,
                        int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(is_bf16, q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 32: return launch<32>(is_bf16, q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 64: return launch<64>(is_bf16, q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 128: return launch<128>(is_bf16, q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 256: return launch<256>(is_bf16, q, k, v, o, lse, BH, BKV, Sq, Sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
