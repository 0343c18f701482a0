// Mamba2 SSD backward for Hopper (sm_90a), f32 in and out, every product on
// the tensor cores in 3xTF32, with a plain C interface (loaded from Python
// with ctypes).
//
// The gradient of the function of ssd.cu, which replaces the TPU kernel
// src/repro/kernels/ssd.py::ssd_tpu (the JAX package takes this gradient
// through XLA; it has no backward kernel). Given dy (b,s,h,p), dS_final
// (b,h,n,p) or null (zero), and what the forward keeps: S_prev, the state
// entering each chunk (b,h,nc,n,p), cum (b,h,nc,Q) and C B^T (b,nc,Qp,Qp),
// it writes dx (b,s,h,p), ddt (b,s,h), dA (h,), dB and dC (b,s,n). Per
// (b, h, chunk), rows i, j of the chunk, w = dt, L_ij = exp(cum_i - cum_j)
// for j <= i (selected, never multiplied: it overflows above the diagonal),
// M_ij = (C B^T)_ij L_ij, G_ij = dy_i . x_j, P_ij = G_ij w_j L_ij and
// dS_out the gradient of the state leaving the chunk:
//   dS_prev = exp(cum_Q) dS_out + sum_i exp(cum_i) C_i^T dy_i (chunks in
//             reverse order, the mirror of the forward's state pass),
//   dx_j    = w_j [sum_i M_ij dy_i + exp(cum_Q - cum_j) B_j dS_out],
//   dC_i    = sum_j (sum_h P)_ij B_j + sum_h exp(cum_i) dy_i S_prev^T,
//   dB_j    = sum_i (sum_h P)_ij C_i + sum_h exp(cum_Q - cum_j) w_j x_j dS_out^T,
//   dw_j    = sum_i M_ij G_ij + st_j, st_j = exp(cum_Q - cum_j) (B_j dS_out) . x_j,
//   dcum    = row sums of T = M w G (= C B^T P) + exp(cum_i) C_i . (dy_i S_prev^T)
//             - w dw (T's column sums and u), the last valid row also
//             + sum_j u_j + exp(cum_Q) <dS_out, S_prev>, u_j = w_j st_j,
//   da = the chunk's reverse cumsum of dcum, ddt = dw + A da, dA = sum dt da.
// B and C are the same for every head, so P is summed over the heads before
// it meets them: P B and P^T C run once per (b, chunk), not once per head.
// kernels/ref.py::ssd_bwd_oracle is the same computation in PyTorch.
//
// Eight kernels on one stream; no float atomics (every sum has a fixed
// order, so every call gives the same bits):
//   1. ssd_bwd_dstate_kernel, a block per (b, h, chunk): the chunk's own
//      sum_i exp(cum_i) C_i^T dy_i (n x p);
//   2. ssd_bwd_state_pass_kernel, elementwise over (b, h, n*p): walks the
//      chunks from the last and turns those into dS_out of each chunk, and
//      its blocks' shares of <dS_out, S_prev>;
//   3. ssd_bwd_dx_kernel, a block per (b, head group, chunk, 64-row j-tile),
//      the j-tiles with the most i-tiles first: walks its heads in order;
//      per head B_j dS_out and x_j dS_out^T (the latter summed over the
//      group's heads), then for each i-tile >= j: G^T = x_j dy_i^T once, M^T
//      and P^T from it, dx_j += M^T dy_i, dw_j, T's partial row sums, and
//      the group's sum of P^T for the tile pair (read back and added in
//      place, in head order);
//   4. ssd_bwd_dc_kernel, a block per (b, head group, chunk, 64-row i-tile):
//      per head dy_i S_prev^T, its dot with C_i (dcum's state term), summed
//      over the group's heads;
//   5. ssd_bwd_sum_groups_kernel, elementwise: the groups' sums of P^T
//      summed in group order;
//   6. ssd_bwd_dbdc_kernel, a block per (b, chunk, 64-row tile, dB or dC):
//      (sum P) B_j or (sum P)^T C_i over the tile pairs, plus the groups'
//      state terms in group order;
//   7. ssd_bwd_dt_kernel, a block per (b, h, chunk): dcum, its reverse
//      cumsum, ddt, and the chunk's share of dA;
//   8. ssd_bwd_da_kernel: dA, the chunks' shares summed in (b, chunk) order.
// The wrapper counts the eight as one launch. The head groups are the fewest
// (a divisor of h) that give kernel 3 MIN_BLOCKS blocks (head_groups below;
// kernels/ssd.py::bwd_head_groups is the same rule).
//
// What bounds it: per (b, h, chunk) the causal halves of dy x^T and M^T dy
// (2 Q^2 p FLOP) and four Q x n x p products (B dS_out, x dS_out^T,
// dy S_prev^T, C^T (exp(cum) dy): 8 Q n p), per (b, chunk) the causal
// halves of (sum P) B and (sum P)^T C (2 Q^2 n), about 1.96e10 FLOP at the
// mamba2-780m training shape (b 2, s 2048, h 48, p 64, n 128, chunk 256),
// three times over in 3xTF32, against ~0.2 GB of inputs and outputs: the
// operations bound it (chip_smoke.py's ssd_bwd_bound_ms). What the design
// does about that: the forward's 3xTF32 mma.sync products (ssd_common.cuh;
// plain TF32 misses the 2e-4 tolerance), C B^T read from the forward's
// scratch instead of recomputed, the upper triangle of each chunk skipped at
// 64-row tile granularity, dy x^T computed once, P B and P^T C once per
// (b, chunk), and every tile a block walks loaded through a ring of two
// cp.async stages, so the next tile is in flight while the tensor cores work
// on this one. Measured (PERF.md): the mma.sync products, with their
// fragment loads from shared memory, hold kernel 3 at about a fifth of the
// TF32 rate; sixteen warps a block instead of eight did not move it. Its
// times are in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int TQ = 64;           // rows of an i-tile or a j-tile; C B^T is padded to it
constexpr int MAX_CHUNK = 4096;  // the chunk's dcum lives in shared memory
constexpr int MAX_N = 128;       // a 64 x n tile of dB or dC is held in registers
constexpr int BW_THREADS = 256;  // 8 warps: 4 16-row m-tiles x 2 column halves
constexpr int PASS_THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int MIN_BLOCKS = 512;  // kernel 3's grid: ~4 waves of 132 SMs at one block an SM

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The fewest head groups, a divisor of h, that give kernel 3 MIN_BLOCKS
// blocks, or h when none does
int head_groups(int b, int h, int nc, int ntile) {
  const long long tiles = (long long)b * nc * ntile;
  for (int g = 1; g < h; ++g)
    if (h % g == 0 && tiles * g >= MIN_BLOCKS) return g;
  return h;
}

// acc[q] += A . B over DEPTH (a multiple of 8) in 3xTF32, for the warp's
// MQ m-tiles of 16 rows and NT n-tiles of 8 columns: a_at(q, r, k) is A's
// element at row r of m-tile q and depth k, b_at(k, c) is B's at depth k
// and column c of the warp's columns
template <int DEPTH, int MQ, int NT, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[MQ][NT][4], int g, int t, FA a_at, FB b_at) {
#pragma unroll
  for (int k0 = 0; k0 < DEPTH; k0 += 8) {
    uint32_t bbig[NT][2], bsml[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      load_b(bbig[nt], bsml[nt], g, t, [&](int k, int c) { return b_at(k0 + k, nt * 8 + c); });
    uint32_t ab[MQ][4], as[MQ][4];
#pragma unroll
    for (int q = 0; q < MQ; ++q)
      load_a(ab[q], as[q], g, t, [&](int r, int k) { return a_at(q, r, k0 + k); });
    mma3(acc, ab, as, bbig, bsml);
  }
}

// The sum of v over the block, the same bits in every thread (a fixed
// order: the warp's butterfly, then the warps in turn)
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();                         // red is free again
  return s;
}

// the sum over the four lanes of a quad (t = lane % 4) that share a row of
// an mma fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum over the eight lanes (g = lane / 4) that share a column of an mma
// fragment, in the same order in every lane
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Shared-memory layouts: rows padded to 4 mod 32 floats where a fragment
// walks a row, 8 mod 32 where it walks a column (bank-conflict-free); every
// region a multiple of 4 floats (16-byte cp.async)
template <int P, int NK>
struct Tiles {
  static constexpr int MQ = (NK + 63) / 64;     // m-tiles a warp of the dstate kernel
  static constexpr int LDC = MQ * 64 + 8;       // dstate: C, walked down its columns
  static constexpr int LDY = P + 8;             // dstate: dy, walked down its columns
  static constexpr int LDP = P + 4;             // x, dy, S_prev, dS_out
  static constexpr int LDA = NK + 4;            // B of the j-tile as an A operand
  static constexpr int LDB = NK + 8;            // B or C as a B operand, walked down
  static constexpr int LDT = TQ + 4;            // C B^T, M^T, sum P^T read along rows
  static constexpr int LDS = TQ + 8;            // sum P^T read down its columns
  // dstate: a stage holds C and dy of an i-tile and its cum
  static constexpr int DSTATE_STAGE = TQ * LDC + TQ * LDY + TQ;
  static constexpr int LDW = TQ / 2 + 4;        // a warp's M^T block, read along rows
  // dx: a ring slot holds a head's dS_out, cum_j, w_j and cum_Q, or an
  // i-tile's dy, C B^T tile and cum_i
  static constexpr int DX_SLOT = cmax(NK * LDP + 2 * TQ + 4, TQ * LDP + TQ * LDT + TQ);
  // dx: the dB state term and the wn 1 warps' partial dx (fragments), B_j,
  // x_j by head parity, each warp's M^T block, cum_j, w_j, 12 x TQ of
  // reductions
  static constexpr int DX_FIXED = NK * TQ + TQ * P + TQ * LDA + 2 * TQ * LDP + 8 * 16 * LDW +
                                  2 * TQ + 12 * TQ;
  // dc: a ring slot holds a head's dy_i, S_prev and cum_i
  static constexpr int DC_SLOT = TQ * LDP + NK * LDP + TQ;
  static constexpr size_t dstate_bytes = sizeof(float) * 2 * DSTATE_STAGE;
  static constexpr size_t dx_bytes = sizeof(float) * (DX_FIXED + 2 * DX_SLOT);
  static constexpr size_t dc_bytes = sizeof(float) * (4 * TQ + 2 * DC_SLOT);
  static constexpr size_t dbdc_bytes = sizeof(float) * (TQ * LDS + 2 * TQ * LDB);
};

// cp.async the (n, P) matrix at src into a (NK, ld) shared tile, rows past n
// zero-filled
template <int P, int NK>
__device__ __forceinline__ void load_state(float* dst, int ld, const float* src, int n) {
  for (int idx = threadIdx.x; idx < NK * (P / 4); idx += BW_THREADS) {
    const int r = idx / (P / 4), col = (idx % (P / 4)) * 4;
    cp_async16(dst + r * ld + col, r < n ? src + (size_t)r * P + col : src, r < n);
  }
}

// cp.async `count` floats of a chunk's per-row vector (row r0 on) at stride
// `stride`, zero past the chunk's valid rows
__device__ __forceinline__ void load_vec(float* dst, const float* src, int r0, int qv,
                                         size_t stride, int count) {
  const int r = threadIdx.x;
  if (r < count) {
    const bool ok = r0 + r < qv;
    cp_async4(dst + r, ok ? src + (size_t)(r0 + r) * stride : src, ok);
  }
}

// A fragment's 64 x 64 tile in registers, 16 floats a thread, is stored as
// four float4 a thread, float4 q of thread tid at q * BW_THREADS + tid
// (coalesced); element e of float4 q is row (warp / 2) * 16 + g + 8 (e / 2),
// column (warp % 2) * 32 + q * 8 + 2 t + e % 2
__device__ __forceinline__ void fragment_at(int tid, int q, int e, int& r, int& col) {
  const int warp = tid >> 5, lane = tid & 31;
  r = (warp >> 1) * 16 + (lane >> 2) + 8 * (e >> 1);
  col = (warp & 1) * (TQ / 2) + q * 8 + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ int pair_index(int it, int jt) { return it * (it + 1) / 2 + jt; }

// ---------------------------------------------------------------------------
// 1. per (b, h, chunk): the chunk's own sum_i exp(cum_i) C_i^T dy_i
// ---------------------------------------------------------------------------

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dstate_kernel(const float* __restrict__ C, const float* __restrict__ dy,
                      const float* __restrict__ cum_g, float* __restrict__ dstates, Dims d) {
  using T = Tiles<P, NK>;
  constexpr int MQ = T::MQ, NTP = P / 16;
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);   // 2 x (C (TQ, LDC), dy (TQ, LDY), cum (TQ))

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int qv = valid_rows(d, c), ntiles = (qv + TQ - 1) / TQ;

  auto issue = [&](int k) {
    float* st = stages + (k & 1) * T::DSTATE_STAGE;
    load_rows<BW_THREADS>(st, T::LDC, C, d, bb, c, k * TQ, TQ, d.n, MQ * 64, d.n, 0);
    load_rows<BW_THREADS>(st + TQ * T::LDC, T::LDY, dy, d, bb, c, k * TQ, TQ, P, P,
                          (size_t)d.h * P, (size_t)hh * P);
    load_vec(st + TQ * (T::LDC + T::LDY), cum_g + bhc * d.Q, k * TQ, qv, 1, TQ);
  };

  // (n, P) = sum over the chunk's rows of (exp(cum) C)^T dy: M = n (m-tiles
  // wm, wm + 4), N = P (warp wn takes P/2 columns), K = rows
  // (C rows past the chunk are zero, so exp(cum) there does not matter)
  float acc[MQ][NTP][4] = {};
  issue(0);
  cp_commit();
  for (int k = 0; k < ntiles; ++k) {
    cp_wait<0>();
    __syncthreads();                       // tile k has landed; tile k - 1 is consumed
    if (k + 1 < ntiles) issue(k + 1);
    cp_commit();
    const float* cs = stages + (k & 1) * T::DSTATE_STAGE;
    const float* dys = cs + TQ * T::LDC;
    const float* cum = dys + TQ * T::LDY;
    gemm<TQ, MQ, NTP>(
        acc, g, t,
        [&](int q, int r, int kk) { return cs[kk * T::LDC + (wm + 4 * q) * 16 + r] * expf(cum[kk]); },
        [&](int kk, int col) { return dys[kk * T::LDY + wn * (P / 2) + col]; });
  }
  float* out = dstates + bhc * d.n * P;
#pragma unroll
  for (int q = 0; q < MQ; ++q) {
    const int r = (wm + 4 * q) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      const int col = wn * (P / 2) + nt * 8 + 2 * t;
      if (r < d.n)
        *reinterpret_cast<float2*>(out + (size_t)r * P + col) =
            make_float2(acc[q][nt][0], acc[q][nt][1]);
      if (r + 8 < d.n)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * P + col) =
            make_float2(acc[q][nt][2], acc[q][nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. per (b, h), chunks from the last: dstates <- dS_out of each chunk
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_state_pass_kernel(float* __restrict__ dstates, const float* __restrict__ ds_final,
                          const float* __restrict__ cum_g, const float* __restrict__ states,
                          float* __restrict__ sdot, int nc, int Q, int np4, int nblk) {
  constexpr int AHEAD = 8;                 // chunks whose own state is loaded at once
  __shared__ float red[PASS_THREADS / 32][AHEAD];
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x, lane = threadIdx.x & 31;
  const bool ok = e < np4;
  const size_t bh = blockIdx.y;
  float4* st = reinterpret_cast<float4*>(dstates + bh * nc * (size_t)np4 * 4) + e;
  const float4* sp = reinterpret_cast<const float4*>(states + bh * nc * (size_t)np4 * 4) + e;
  float4 run = ds_final && ok ? reinterpret_cast<const float4*>(ds_final + bh * (size_t)np4 * 4)[e]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int top = nc - 1; top >= 0; top -= AHEAD) {
    float4 own[AHEAD], prev[AHEAD];
    float g[AHEAD], dot[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (ok && top - k >= 0) {
        own[k] = st[(size_t)(top - k) * np4];
        prev[k] = sp[(size_t)(top - k) * np4];
        g[k] = expf(cum_g[(bh * nc + top - k) * Q + Q - 1]);   // the chunk's decay
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      dot[k] = 0.f;
      if (ok && top - k >= 0) {
        st[(size_t)(top - k) * np4] = run;
        dot[k] = run.x * prev[k].x + run.y * prev[k].y + run.z * prev[k].z + run.w * prev[k].w;
        run = make_float4(g[k] * run.x + own[k].x, g[k] * run.y + own[k].y,
                          g[k] * run.z + own[k].z, g[k] * run.w + own[k].w);
      }
    }
    // <dS_out, S_prev> of each chunk: this block's share, summed over its
    // warps in order
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
#pragma unroll
      for (int o = 16; o; o >>= 1) dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
      if (lane == 0) red[threadIdx.x >> 5][k] = dot[k];
    }
    __syncthreads();
    if (threadIdx.x < AHEAD && top - (int)threadIdx.x >= 0) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < PASS_THREADS / 32; ++w) v += red[w][threadIdx.x];
      sdot[(bh * nc + top - threadIdx.x) * nblk + blockIdx.x] = v;
    }
    __syncthreads();                       // red is free again
  }
}

// ---------------------------------------------------------------------------
// 3. per (b, head group, chunk, j-tile): per head dx_j, dw_j, u_j and T's
//    partial row sums; the group's sums of P^T and of the state term of dB_j
// ---------------------------------------------------------------------------
//
// Warp (wm, wn) owns rows r0 = 16 wm .. r0 + 15 of the j-tile and, of each
// i-tile, the columns i of its half wn: it forms G^T, M^T and P^T there and
// adds M^T dy_i over those 32 rows of dy into a partial dx_j over all P
// columns; the two halves' partials are summed (wn 0 + wn 1) once a head.
// Within an i-tile no warp waits on another, so one block barrier an item
// (its tiles have landed, and the slot the next load fills is free again)
// is all the ring needs. T's column sums are reduced over the four m-tiles
// at the next item's barrier.

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ B, const float* __restrict__ dy,
                  const float* __restrict__ cum_g, const float* __restrict__ dstates,
                  const float* __restrict__ cb, float* __restrict__ dx, float* __restrict__ sump,
                  float* __restrict__ dBg, float* __restrict__ rowp, float* __restrict__ dw,
                  float* __restrict__ u, Dims d, int groups) {
  using T = Tiles<P, NK>;
  constexpr int NTN = NK / 16, NTP = P / 8, NTI = TQ / 16;
  extern __shared__ float4 smem4[];
  float4* dbs = smem4;                          // (NTN, BW_THREADS) the group's dB state term,
                                                // a thread's fragments
  float4* dxs = dbs + NTN * BW_THREADS;         // (4, NTP, 32) the wn 1 warps' partial dx_j
  float* bsj = reinterpret_cast<float*>(dxs + 4 * NTP * 32);  // (TQ, LDA) B of the j-tile
  float* xs2 = bsj + TQ * T::LDA;               // 2 x (TQ, LDP) x of the j-tile, by head parity
  float* mw = xs2 + 2 * TQ * T::LDP;            // 8 x (16, LDW) each warp's M^T block
  float* cum_j = mw + 8 * 16 * T::LDW;          // (TQ) this head's cum_j
  float* w_j = cum_j + TQ;                      // (TQ) this head's dt_j
  float* redc = w_j + TQ;                       // 2 x (4, TQ) T's column sums by m-tile, by item parity
  float* redh = redc + 8 * TQ;                  // (2, 2, TQ) dw's first term and st by column half
  float* slots = redh + 4 * TQ;                 // 2 x DX_SLOT: the ring

  // blockIdx.y is the j-tile: the blocks with the most i-tiles go first
  const int jt = blockIdx.y, c = blockIdx.x % d.nc;
  const int grp = (blockIdx.x / d.nc) % groups, bb = blockIdx.x / (d.nc * groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, r0 = wm * 16, wn = warp & 1;
  const int j0 = jt * TQ, qv = valid_rows(d, c);
  if (j0 >= qv) return;                    // the ragged chunk's empty tiles
  const int hg = d.h / groups, h0 = grp * hg;
  const int ni = (qv - j0 + TQ - 1) / TQ;      // i-tiles jt .. jt + ni - 1
  const int per_head = 1 + ni, items = hg * per_head;
  const size_t xstride = (size_t)d.h * P;
  const float* cbc = cb + ((size_t)bb * d.nc + c) * d.Qp * d.Qp;
  float* sumc = sump + ((size_t)(bb * groups + grp) * d.nc + c) * (d.ntile * (d.ntile + 1) / 2) *
                           (TQ * TQ);
  float* mine = mw + warp * 16 * T::LDW;

  // the ring's items, per head in group order: the head's dS_out (and x_j
  // into its own buffer), then each of its i-tiles' dy and C B^T tile
  auto issue = [&](int k) {
    const int hl = k / per_head, m = k % per_head, hh = h0 + hl;
    const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
    float* sl = slots + (k & 1) * T::DX_SLOT;
    if (m == 0) {
      if (k == 0) load_rows<BW_THREADS>(bsj, T::LDA, B, d, bb, c, j0, TQ, d.n, NK, d.n, 0);
      load_rows<BW_THREADS>(xs2 + (hl & 1) * TQ * T::LDP, T::LDP, x, d, bb, c, j0, TQ, P, P,
                            xstride, (size_t)hh * P);
      load_state<P, NK>(sl, T::LDP, dstates + bhc * d.n * P, d.n);
      float* hv = sl + NK * T::LDP;            // cum_j, w_j, cum_Q
      load_vec(hv, cum_g + bhc * d.Q, j0, qv, 1, TQ);
      if (tid >= TQ && tid < 2 * TQ) {
        const int r = tid - TQ;
        const bool ok = j0 + r < qv;
        cp_async4(hv + TQ + r, ok ? dt + ((size_t)bb * d.s + (size_t)c * d.Q + j0 + r) * d.h + hh
                                  : dt, ok);
      }
      if (tid == 2 * TQ) cp_async4(hv + 2 * TQ, cum_g + bhc * d.Q + d.Q - 1, true);
    } else {
      const int i0 = (jt + m - 1) * TQ;
      load_rows<BW_THREADS>(sl, T::LDP, dy, d, bb, c, i0, TQ, P, P, xstride, (size_t)hh * P);
      float* cbs = sl + TQ * T::LDP;           // cb rows i0.., columns j0..
      for (int idx = tid; idx < TQ * (TQ / 4); idx += BW_THREADS) {
        const int r = idx / (TQ / 4), c4 = (idx % (TQ / 4)) * 4;
        cp_async16(cbs + r * T::LDT + c4, cbc + (size_t)(i0 + r) * d.Qp + j0 + c4, true);
      }
      load_vec(cbs + TQ * T::LDT, cum_g + bhc * d.Q, i0, qv, 1, TQ);
    }
  };
  // T's row sums of item k's i-tile, the four m-tiles' in order
  auto flush_rows = [&](int k) {
    const int hl = k / per_head, m = k % per_head, i0 = (jt + m - 1) * TQ;
    if (m == 0 || tid >= TQ || i0 + tid >= qv) return;
    const float* rc = redc + (k & 1) * 4 * TQ;
    const size_t bhc = ((size_t)bb * d.h + h0 + hl) * d.nc + c;
    rowp[(bhc * d.ntile + jt) * d.Q + i0 + tid] =
        rc[tid] + rc[TQ + tid] + rc[2 * TQ + tid] + rc[3 * TQ + tid];
  };

  float dxa[1][NTP][4] = {};   // this head's dx_j / w_j over the warp's half of each i-tile
  float dwi[2] = {0.f, 0.f}, sst[2] = {0.f, 0.f};
  issue(0);
  cp_commit();
  for (int k = 0; k < items; ++k) {
    cp_wait<0>();
    __syncthreads();                           // item k has landed; item k - 1 is done
    if (k > 0) flush_rows(k - 1);
    if (k + 1 < items) issue(k + 1);
    cp_commit();
    const int hl = k / per_head, m = k % per_head, hh = h0 + hl;
    const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
    const float* sl = slots + (k & 1) * T::DX_SLOT;
    const float* xs = xs2 + (hl & 1) * TQ * T::LDP;
    if (m == 0) {
      // the head's state terms: dx starts at exp(cum_Q - cum_j) B_j dS_out
      // (each column half wn over its half of n), st = exp(cum_Q - cum_j)
      // (B_j dS_out) . x_j, and the group's dB state term gains
      // exp(cum_Q - cum_j) w_j x_j dS_out^T
      const float* dso = sl;
      const float* hv = sl + NK * T::LDP;
      if (tid < TQ) {
        cum_j[tid] = hv[tid];
        w_j[tid] = hv[TQ + tid];
      }
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[0][nt][e] = 0.f;
      gemm<NK / 2, 1, NTP>(
          dxa, g, t, [&](int, int r, int kk) { return bsj[(r0 + r) * T::LDA + wn * (NK / 2) + kk]; },
          [&](int kk, int col) { return dso[(wn * (NK / 2) + kk) * T::LDP + col]; });
      float za[1][NTN][4] = {};
      gemm<P, 1, NTN>(
          za, g, t, [&](int, int r, int kk) { return xs[(r0 + r) * T::LDP + kk]; },
          [&](int kk, int col) { return dso[(wn * (NK / 2) + col) * T::LDP + kk]; });
      float ew[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        const float e = j0 + r < qv ? expf(hv[2 * TQ] - hv[r]) : 0.f;
        ew[half] = e * hv[TQ + r];
        float sv = 0.f;
#pragma unroll
        for (int nt = 0; nt < NTP; ++nt) {
          const int col = nt * 8 + 2 * t;
          sv += dxa[0][nt][2 * half] * xs[r * T::LDP + col] +
                dxa[0][nt][2 * half + 1] * xs[r * T::LDP + col + 1];
          dxa[0][nt][2 * half] *= e;
          dxa[0][nt][2 * half + 1] *= e;
        }
        sst[half] = sv * e;
        dwi[half] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        float4 v = hl ? dbs[nt * BW_THREADS + tid] : make_float4(0.f, 0.f, 0.f, 0.f);
        v.x += ew[0] * za[0][nt][0];
        v.y += ew[0] * za[0][nt][1];
        v.z += ew[1] * za[0][nt][2];
        v.w += ew[1] * za[0][nt][3];
        dbs[nt * BW_THREADS + tid] = v;
      }
    } else {
      const int it = jt + m - 1, i0 = it * TQ;
      const float* dys = sl;
      const float* cbs = sl + TQ * T::LDP;
      const float* cum_i = cbs + TQ * T::LDT;
      float4* tile = reinterpret_cast<float4*>(sumc + (size_t)pair_index(it, jt) * (TQ * TQ));
      float4 old[NTI];
      if (hl > 0) {                            // the group's sum so far, written by this thread
#pragma unroll
        for (int nt = 0; nt < NTI; ++nt) old[nt] = tile[nt * BW_THREADS + tid];
      }
      // G^T = x_j dy_i^T (rows j, the warp's columns i); M^T and P^T on the causal mask
      float gacc[1][NTI][4] = {};
      gemm<P, 1, NTI>(
          gacc, g, t, [&](int, int r, int kk) { return xs[(r0 + r) * T::LDP + kk]; },
          [&](int kk, int col) { return dys[(wn * (TQ / 2) + col) * T::LDP + kk]; });
      float* rc = redc + (k & 1) * 4 * TQ + wm * TQ + wn * (TQ / 2);
#pragma unroll
      for (int nt = 0; nt < NTI; ++nt) {
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = g + 8 * (e >> 1), cl = nt * 8 + 2 * t + (e & 1);
          const int r = r0 + rl, col = wn * (TQ / 2) + cl;
          const int lj = j0 + r, li = i0 + col;
          float mv = 0.f, pv = 0.f;
          if (lj <= li && li < qv) {
            const float l = expf(cum_i[col] - cum_j[r]), cbv = cbs[col * T::LDT + r];
            mv = cbv * l;
            pv = gacc[0][nt][e] * w_j[r] * l;
            dwi[e >> 1] += mv * gacc[0][nt][e];
            rs[e & 1] += cbv * pv;
          }
          mine[rl * T::LDW + cl] = mv;
          gacc[0][nt][e] = pv;
        }
        float4 v = make_float4(gacc[0][nt][0], gacc[0][nt][1], gacc[0][nt][2], gacc[0][nt][3]);
        if (hl > 0)
          v = make_float4(old[nt].x + v.x, old[nt].y + v.y, old[nt].z + v.z, old[nt].w + v.w);
        tile[nt * BW_THREADS + tid] = v;
#pragma unroll
        for (int e = 0; e < 2; ++e) rs[e] = column_sum(rs[e]);
        if (g == 0) {
          rc[nt * 8 + 2 * t] = rs[0];
          rc[nt * 8 + 2 * t + 1] = rs[1];
        }
      }
      __syncwarp();                            // the warp's M^T block is in
      // dx_j += M^T dy_i over the warp's 32 rows i
      gemm<TQ / 2, 1, NTP>(
          dxa, g, t, [&](int, int r, int kk) { return mine[r * T::LDW + kk]; },
          [&](int kk, int col) { return dys[(wn * (TQ / 2) + kk) * T::LDP + col]; });
      if (m == ni) {                           // the head's last i-tile: its dx, dw and u
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + g + 8 * half;
          const float di = quad_sum(dwi[half]), sv = quad_sum(sst[half]);
          if (t == 0) {
            redh[wn * TQ + r] = di;
            redh[(2 + wn) * TQ + r] = sv;
          }
        }
        if (wn) {
#pragma unroll
          for (int nt = 0; nt < NTP; ++nt)
            dxs[(wm * NTP + nt) * 32 + lane] =
                make_float4(dxa[0][nt][0], dxa[0][nt][1], dxa[0][nt][2], dxa[0][nt][3]);
        }
        __syncthreads();
        if (!wn) {                             // dx_j = w_j (wn 0's partial + wn 1's)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + g + 8 * half, lj = j0 + r;
            if (lj >= qv) continue;
            const float w = w_j[r];
            float* out = dx + ((size_t)bb * d.s + (size_t)c * d.Q + lj) * xstride +
                         (size_t)hh * P + 2 * t;
#pragma unroll
            for (int nt = 0; nt < NTP; ++nt) {
              const float4 o = dxs[(wm * NTP + nt) * 32 + lane];
              *reinterpret_cast<float2*>(out + nt * 8) =
                  half ? make_float2(w * (dxa[0][nt][2] + o.z), w * (dxa[0][nt][3] + o.w))
                       : make_float2(w * (dxa[0][nt][0] + o.x), w * (dxa[0][nt][1] + o.y));
            }
          }
        }
        if (tid < TQ && j0 + tid < qv) {
          const float di = redh[tid] + redh[TQ + tid];
          const float sv = redh[2 * TQ + tid] + redh[3 * TQ + tid];
          const size_t o = bhc * d.Q + j0 + tid;
          dw[o] = di + sv;
          u[o] = w_j[tid] * sv;
        }
      }
    }
  }
  __syncthreads();
  flush_rows(items - 1);

  // the group's dB state term for the j-tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half, lj = j0 + r;
    if (lj >= qv) continue;
    float* out = dBg + (((size_t)bb * groups + grp) * d.s + (size_t)c * d.Q + lj) * d.n;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      const float4 v = dbs[nt * BW_THREADS + tid];
      if (col < d.n)
        *reinterpret_cast<float2*>(out + col) = half ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. per (b, head group, chunk, i-tile): per head dcum's state term
//    exp(cum_i) C_i . (dy_i S_prev^T); the group's sum of exp(cum_i) dy_i S_prev^T
// ---------------------------------------------------------------------------

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dc_kernel(const float* __restrict__ C, const float* __restrict__ dy,
                  const float* __restrict__ cum_g, const float* __restrict__ states,
                  float* __restrict__ dCg, float* __restrict__ rows, Dims d, int groups) {
  using T = Tiles<P, NK>;
  constexpr int NTN = NK / 16;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // 2 x (2, TQ) row sums by column half, by head parity
  float* slots = red + 4 * TQ;                   // 2 x (dy (TQ, LDP), S_prev (NK, LDP), cum (TQ))

  const int c = blockIdx.x / d.ntile, it = blockIdx.x % d.ntile;
  const int grp = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp >> 1) * 16, wn = warp & 1;
  const int i0 = it * TQ, qv = valid_rows(d, c);
  if (i0 >= qv) return;                    // the ragged chunk's empty tiles
  const int hg = d.h / groups, h0 = grp * hg;
  const size_t xstride = (size_t)d.h * P;

  auto issue = [&](int k) {
    const size_t bhc = ((size_t)bb * d.h + h0 + k) * d.nc + c;
    float* sl = slots + (k & 1) * T::DC_SLOT;
    load_rows<BW_THREADS>(sl, T::LDP, dy, d, bb, c, i0, TQ, P, P, xstride, (size_t)(h0 + k) * P);
    load_state<P, NK>(sl + TQ * T::LDP, T::LDP, states + bhc * d.n * P, d.n);
    load_vec(sl + (TQ + NK) * T::LDP, cum_g + bhc * d.Q, i0, qv, 1, TQ);
  };

  // dcum's state term of head k, the two column halves' in order
  auto flush_rows = [&](int k) {
    if (tid < TQ && i0 + tid < qv) {
      const float* rk = red + (k & 1) * 2 * TQ;
      rows[(((size_t)bb * d.h + h0 + k) * d.nc + c) * d.Q + i0 + tid] = rk[tid] + rk[TQ + tid];
    }
  };

  float dca[1][NTN][4] = {};   // sum over the group's heads of exp(cum_i) dy_i S_prev^T
  issue(0);
  cp_commit();
  for (int k = 0; k < hg; ++k) {
    cp_wait<0>();
    __syncthreads();                       // head k has landed; head k - 1 is done
    if (k > 0) flush_rows(k - 1);
    if (k + 1 < hg) issue(k + 1);
    cp_commit();
    const float* dys = slots + (k & 1) * T::DC_SLOT;
    const float* sps = dys + TQ * T::LDP;
    const float* cum_i = sps + NK * T::LDP;
    float ya[1][NTN][4] = {};
    gemm<P, 1, NTN>(
        ya, g, t, [&](int, int r, int kk) { return dys[(r0 + r) * T::LDP + kk]; },
        [&](int kk, int col) { return sps[(wn * (NK / 2) + col) * T::LDP + kk]; });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half, li = i0 + r;
      const bool ok = li < qv;
      const float e = ok ? expf(cum_i[r]) : 0.f;
      const float* crow = C + ((size_t)bb * d.s + (size_t)c * d.Q + (ok ? li : 0)) * d.n;
      float rsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const int col = wn * (NK / 2) + nt * 8 + 2 * t;
        if (ok && col < d.n) {
          const float2 cv = __ldg(reinterpret_cast<const float2*>(crow + col));
          rsum += cv.x * ya[0][nt][2 * half] + cv.y * ya[0][nt][2 * half + 1];
        }
        dca[0][nt][2 * half] += e * ya[0][nt][2 * half];
        dca[0][nt][2 * half + 1] += e * ya[0][nt][2 * half + 1];
      }
      const float v = quad_sum(rsum * e);
      if (t == 0) red[(k & 1) * 2 * TQ + wn * TQ + r] = v;
    }
  }
  __syncthreads();
  flush_rows(hg - 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half, li = i0 + r;
    if (li >= qv) continue;
    float* out = dCg + (((size_t)bb * groups + grp) * d.s + (size_t)c * d.Q + li) * d.n;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      if (col < d.n)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(dca[0][nt][2 * half], dca[0][nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 5. elementwise over the tile pairs: the groups' sums of P^T, summed in
//    group order into group 0's
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_sum_groups_kernel(float* __restrict__ sump, int groups, long long per_group4) {
  const long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= per_group4) return;
  float4* at = reinterpret_cast<float4*>(sump) + (size_t)blockIdx.y * groups * per_group4 + e;
  float4 acc = at[0];
  for (int gr = 1; gr < groups; ++gr) {
    const float4 v = at[(size_t)gr * per_group4];
    acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  at[0] = acc;
}

// ---------------------------------------------------------------------------
// 6. per (b, chunk, tile, dB or dC): sum P over the groups, then
//    dC_i = sum_j (sum P)_ij B_j or dB_j = sum_i (sum P)^T_ji C_i, plus the
//    groups' state terms, each in a fixed order
// ---------------------------------------------------------------------------

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dbdc_kernel(const float* __restrict__ B, const float* __restrict__ C,
                    const float* __restrict__ sump, const float* __restrict__ dBg,
                    const float* __restrict__ dCg, float* __restrict__ dB,
                    float* __restrict__ dC, Dims d, int groups) {
  using T = Tiles<P, NK>;
  constexpr int NTN = NK / 16, NTI = TQ / 16;
  extern __shared__ float4 smem4[];
  float* sps = reinterpret_cast<float*>(smem4);  // (TQ, LDT or LDS) sum P^T (rows j, columns i)
  float* ops = sps + TQ * T::LDS;                // 2 x (TQ, LDB) B_j or C_i

  const int c = blockIdx.x / d.ntile, tt = blockIdx.x % d.ntile;
  const bool want_db = blockIdx.y;             // rows j of tile tt; else dC, rows i
  const int bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp >> 1) * 16, wn = warp & 1;
  const int t0 = tt * TQ, qv = valid_rows(d, c);
  if (t0 >= qv) return;
  const int ld = want_db ? T::LDT : T::LDS;
  // dC_i: j-tiles 0 .. tt; dB_j: i-tiles tt .. the last valid one
  const int pairs = want_db ? (qv - t0 + TQ - 1) / TQ : tt + 1;
  const int npairs = d.ntile * (d.ntile + 1) / 2;
  const float* src = want_db ? C : B;

  auto issue = [&](int k) {
    const int ot = want_db ? tt + k : k;       // the operand's tile
    load_rows<BW_THREADS>(ops + (k & 1) * TQ * T::LDB, T::LDB, src, d, bb, c, ot * TQ, TQ, d.n,
                          NK, d.n, 0);
  };

  float acc[1][NTN][4] = {};
  issue(0);
  cp_commit();
  for (int k = 0; k < pairs; ++k) {
    if (k + 1 < pairs) issue(k + 1);
    cp_commit();
    const int it = want_db ? tt + k : tt, jt = want_db ? tt : k;
    // the heads' sum of P^T for the tile pair: group 0's slot after kernel 5
    const float4* tile = reinterpret_cast<const float4*>(
        sump + (((size_t)bb * groups * d.nc + c) * npairs + pair_index(it, jt)) * (TQ * TQ));
#pragma unroll
    for (int q = 0; q < NTI; ++q) {
      const float4 sq = __ldg(tile + q * BW_THREADS + tid);
      const float v[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, col;
        fragment_at(tid, q, e, r, col);
        sps[r * ld + col] = v[e];
      }
    }
    cp_wait<1>();
    __syncthreads();
    const float* os = ops + (k & 1) * TQ * T::LDB;
    if (want_db)   // dB_j += (sum P)^T_ji C_i: A rows j, depth i
      gemm<TQ, 1, NTN>(
          acc, g, t, [&](int, int r, int kk) { return sps[(r0 + r) * ld + kk]; },
          [&](int kk, int col) { return os[kk * T::LDB + wn * (NK / 2) + col]; });
    else           // dC_i += (sum P)_ij B_j: A rows i, depth j
      gemm<TQ, 1, NTN>(
          acc, g, t, [&](int, int r, int kk) { return sps[kk * ld + r0 + r]; },
          [&](int kk, int col) { return os[kk * T::LDB + wn * (NK / 2) + col]; });
    __syncthreads();                       // the tiles are consumed
  }

  const float* part = want_db ? dBg : dCg;
  float* outg = want_db ? dB : dC;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half, lr = t0 + r;
    if (lr >= qv) continue;
    const size_t row = (size_t)bb * d.s + (size_t)c * d.Q + lr;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      if (col >= d.n) continue;
      float2 v = make_float2(acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
      for (int gr = 0; gr < groups; ++gr) {   // the groups' state terms, in group order
        const float2 s = __ldg(reinterpret_cast<const float2*>(
            part + (((size_t)bb * groups + gr) * d.s + (size_t)c * d.Q + lr) * d.n + col));
        v = make_float2(v.x + s.x, v.y + s.y);
      }
      *reinterpret_cast<float2*>(outg + row * d.n + col) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// 7. per (b, h, chunk): dcum, da (its reverse cumsum), ddt and dA's share
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ cum_g, const float* __restrict__ sdot,
                  const float* __restrict__ rowp, const float* __restrict__ rows,
                  const float* __restrict__ dw, const float* __restrict__ u,
                  float* __restrict__ ddt, float* __restrict__ dapart, int nblk, Dims d) {
  constexpr int NW = BW_THREADS / 32;
  __shared__ float red[NW], wtot[NW];
  extern __shared__ float4 smem4[];
  float* dcum = reinterpret_cast<float*>(smem4);   // (Q)

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c, rb = bhc * d.Q;
  const int qv = valid_rows(d, c);

  float su = 0.f;                          // sum_j u_j
  for (int r = tid; r < qv; r += BW_THREADS) su += u[rb + r];
  su = block_sum<BW_THREADS>(su, red);
  float sp = 0.f;                          // <dS_out, S_prev>: the state pass's blocks in order
  for (int k = 0; k < nblk; ++k) sp += sdot[bhc * nblk + k];
  // T's row sums over the j-tiles in order, dcum's state term, minus w dw
  // (T's column sums and u)
  for (int r = tid; r < d.Q; r += BW_THREADS) {
    float v = 0.f;
    if (r < qv) {
      const float* rp = rowp + bhc * d.ntile * d.Q + r;
      for (int jt = 0; jt * TQ <= r; ++jt) v += rp[(size_t)jt * d.Q];
      const float w = dt[((size_t)bb * d.s + (size_t)c * d.Q + r) * d.h + hh];
      v = v + rows[rb + r] - w * dw[rb + r];
    }
    dcum[r] = v;
  }
  __syncthreads();
  if (tid == 0) dcum[qv - 1] += su + expf(cum_g[rb + d.Q - 1]) * sp;
  __syncthreads();

  // da_r = sum_{k >= r} dcum_k: an inclusive scan over the rows from the last
  const float Ah = A[hh];
  float carry = 0.f, dsum = 0.f;
  for (int base = 0; base < d.Q; base += BW_THREADS) {
    const int r = d.Q - 1 - base - tid;
    float v = r >= 0 ? dcum[r] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    float before = carry, tot = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) before += wtot[w];
      tot += wtot[w];
    }
    if (r >= 0 && r < qv) {
      const size_t o = ((size_t)bb * d.s + (size_t)c * d.Q + r) * d.h + hh;
      const float da = before + v;
      ddt[o] = dw[rb + r] + Ah * da;
      dsum += dt[o] * da;
    }
    carry += tot;
    __syncthreads();                       // wtot is free again
  }
  dsum = block_sum<BW_THREADS>(dsum, red);
  if (tid == 0) dapart[bhc] = dsum;
}

// ---------------------------------------------------------------------------
// 8. dA: the chunks' shares summed in (b, chunk) order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_da_kernel(const float* __restrict__ dapart, float* __restrict__ dA, Dims d) {
  const int hh = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (hh >= d.h) return;
  float s = 0.f;
  for (int bb = 0; bb < d.b; ++bb)
    for (int c = 0; c < d.nc; ++c) s += dapart[((size_t)bb * d.h + hh) * d.nc + c];
  dA[hh] = s;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const float *x, *dt, *A, *B, *C, *dy, *ds_final, *states, *cum, *cb;
  float *dx, *ddt, *dA, *dB, *dC;
  float *dstates, *sdot, *sump, *dBg, *dCg, *rowp, *rows, *dw, *u, *dapart;
};

// Set a kernel's dynamic shared-memory limit once per device (the call is
// host work, and training calls the backward on every layer); `done` holds a
// bit per device.
template <class K>
cudaError_t smem_limit_once(K kernel, size_t bytes, unsigned long long& done) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && (done >> device) & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

template <int P, int NK>
cudaError_t launch(const Args& a, const Dims& d, int groups, cudaStream_t st) {
  using T = Tiles<P, NK>;
  static unsigned long long dstate_ready = 0, dx_ready = 0, dc_ready = 0, dbdc_ready = 0;
  cudaError_t err;
  if ((err = smem_limit_once(ssd_bwd_dstate_kernel<P, NK>, T::dstate_bytes, dstate_ready)) !=
          cudaSuccess ||
      (err = smem_limit_once(ssd_bwd_dx_kernel<P, NK>, T::dx_bytes, dx_ready)) != cudaSuccess ||
      (err = smem_limit_once(ssd_bwd_dc_kernel<P, NK>, T::dc_bytes, dc_ready)) != cudaSuccess ||
      (err = smem_limit_once(ssd_bwd_dbdc_kernel<P, NK>, T::dbdc_bytes, dbdc_ready)) !=
          cudaSuccess)
    return err;
  const dim3 per_chunk(d.nc, d.h, d.b), per_group_tile(d.nc * d.ntile, groups, d.b);
  ssd_bwd_dstate_kernel<P, NK><<<per_chunk, BW_THREADS, T::dstate_bytes, st>>>(
      a.C, a.dy, a.cum, a.dstates, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np4 = d.n * P / 4, nblk = (np4 + PASS_THREADS - 1) / PASS_THREADS;
  ssd_bwd_state_pass_kernel<<<dim3(nblk, d.b * d.h), PASS_THREADS, 0, st>>>(
      a.dstates, a.ds_final, a.cum, a.states, a.sdot, d.nc, d.Q, np4, nblk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx_kernel<P, NK><<<dim3(d.nc * groups * d.b, d.ntile), BW_THREADS, T::dx_bytes, st>>>(
      a.x, a.dt, a.B, a.dy, a.cum, a.dstates, a.cb, a.dx, a.sump, a.dBg, a.rowp, a.dw, a.u, d,
      groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dc_kernel<P, NK><<<per_group_tile, BW_THREADS, T::dc_bytes, st>>>(
      a.C, a.dy, a.cum, a.states, a.dCg, a.rows, d, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long per_group4 = (long long)d.nc * (d.ntile * (d.ntile + 1) / 2) * (TQ * TQ / 4);
  ssd_bwd_sum_groups_kernel<<<dim3((unsigned)((per_group4 + SUM_THREADS - 1) / SUM_THREADS), d.b),
                              SUM_THREADS, 0, st>>>(a.sump, groups, per_group4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dbdc_kernel<P, NK><<<dim3(d.nc * d.ntile, 2, d.b), BW_THREADS, T::dbdc_bytes, st>>>(
      a.B, a.C, a.sump, a.dBg, a.dCg, a.dB, a.dC, d, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dt_kernel<<<per_chunk, BW_THREADS, sizeof(float) * d.Q, st>>>(
      a.dt, a.A, a.cum, a.sdot, a.rowp, a.rows, a.dw, a.u, a.ddt, a.dapart, nblk, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(d.h + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(a.dapart,
                                                                                  a.dA, d);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Args& a, const Dims& d, int groups, cudaStream_t st) {
  if (d.n <= 16) return launch<P, 16>(a, d, groups, st);
  if (d.n <= 32) return launch<P, 32>(a, d, groups, st);
  if (d.n <= 64) return launch<P, 64>(a, d, groups, st);
  return launch<P, 128>(a, d, groups, st);
}

}  // namespace

extern "C" {

// Inputs as ssd_fwd took them (x (b,s,h,p), dt (b,s,h), A (h,), B/C
// (b,s,n)), dy (b,s,h,p), ds_final (b,h,n,p) or null, and ssd_fwd's
// scratch after its call: states (b,h,nc,n,p), cum (b,h,nc,Q) and cb
// (b,nc,Qp,Qp). Writes dx (b,s,h,p), ddt (b,s,h), dA (h,), dB and dC
// (b,s,n). Scratch from the caller, with G = head_groups(b, h, nc, ntile):
// dstates (b,h,nc,n,p), sdot (b,h,nc,ceil(n p / 1024)), sump
// (b,G,nc,ntile (ntile + 1) / 2,64,64), dBg and
// dCg (b,G,s,n), rowp (b,h,nc,ntile,Q), rows, dw and u (b,h,nc,Q), dapart
// (b,h,nc). All f32, contiguous, 16-byte aligned, on the current device;
// chunk = min(chunk, s) as the forward took it, p in {16, 32, 64}, n a
// multiple of 4 up to 128. Launches the eight kernels on `stream` without
// synchronising; returns the first launch error (cudaGetLastError()), or
// cudaErrorInvalidValue.
int ssd_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
            const void* dy, const void* ds_final, const void* states, const void* cum,
            const void* cb, void* dx, void* ddt, void* dA, void* dB, void* dC, void* dstates,
            void* sdot, void* sump, void* dBg, void* dCg, void* rowp, void* rows, void* dw,
            void* u, void* dapart, int b, int s, int h, int p, int n, int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 || n <= 0 || n % 4 ||
      n > MAX_N || chunk <= 0 || chunk > MAX_CHUNK || chunk > s)
    return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk, ntile = (chunk + TQ - 1) / TQ;
  Dims d{b, s, h, n, (n + 15) / 16 * 16, chunk, nc, ntile, ntile * TQ};
  if ((long long)nc * ntile > 0x7fffffffLL || (long long)b * h > 65535 || nc > 65535 ||
      (long long)nc * b * h > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto in = [](const void* v) { return static_cast<const float*>(v); };
  auto out = [](void* v) { return static_cast<float*>(v); };
  const Args a{in(x),       in(dt),      in(A),      in(B),     in(C),        in(dy),
               in(ds_final), in(states), in(cum),    in(cb),    out(dx),      out(ddt),
               out(dA),     out(dB),     out(dC),    out(dstates), out(sdot), out(sump),
               out(dBg),    out(dCg),    out(rowp),  out(rows), out(dw),      out(u),
               out(dapart)};
  const int groups = head_groups(b, h, nc, ntile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return launch_p<16>(a, d, groups, st);
    case 32: return launch_p<32>(a, d, groups, st);
    case 64: return launch_p<64>(a, d, groups, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
