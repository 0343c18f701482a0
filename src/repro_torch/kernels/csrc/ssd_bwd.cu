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
//   dC_i    = sum_h [P B + exp(cum_i) dy_i S_prev^T]_i,
//   dB_j    = sum_h [P^T C + exp(cum_Q - cum_j) w_j x_j dS_out^T]_j,
//   dw_j    = sum_i M_ij G_ij + exp(cum_Q - cum_j) (B_j dS_out) . x_j,
//   dcum    = row sums of T = M w G (= C B^T P) minus its column sums
//             (= w dw's first term) + exp(cum_i) C_i . (dy_i S_prev^T) - u_j,
//             and the last valid row + sum_j u_j + exp(cum_Q) <dS_out, S_prev>,
//             u_j = w_j exp(cum_Q - cum_j) (B_j dS_out) . x_j,
//   da = the chunk's reverse cumsum of dcum, ddt = dw + A da, dA = sum dt da.
// kernels/ref.py::ssd_bwd_oracle is the same computation in PyTorch.
//
// Seven kernels on one stream, the forward's decomposition mirrored; no
// float atomics (every sum has a fixed order, so every call gives the same
// bits):
//   1. ssd_bwd_dstate_kernel, a block per (b, h, chunk): the chunk's own
//      sum_i exp(cum_i) C_i^T dy_i (n x p);
//   2. ssd_bwd_state_pass_kernel, elementwise over (b, h, n*p): walks the
//      chunks from the last and turns those into dS_out of each chunk;
//   3. ssd_bwd_dc_kernel, a block per (b, h, chunk, 64-row i-tile): this
//      head's share of dC_i and the row sums of dcum (j-tiles j <= i);
//   4. ssd_bwd_dx_kernel, a block per (b, h, chunk, 64-row j-tile): dx_j,
//      this head's share of dB_j, dw_j, the column sums of dcum and u_j
//      (i-tiles i >= j);
//   5. ssd_bwd_dt_kernel, a block per (b, h, chunk): dcum, its reverse
//      cumsum, ddt, and the chunk's share of dA;
//   6. ssd_bwd_sum_heads_kernel: dB and dC, the heads' shares summed in
//      head order;
//   7. ssd_bwd_da_kernel: dA, the chunks' shares summed in (b, chunk) order.
// The wrapper counts the seven as one launch.
//
// What bounds it: per (b, h, chunk) the causal halves of dy x^T, M^T dy,
// P B and P^T C (2 Q^2 p + 2 Q^2 n FLOP) and four Q x n x p products
// (B dS_out, x dS_out^T, dy S_prev^T, C^T (exp(cum) dy): 8 Q n p), about
// 3.2e10 FLOP at the mamba2-780m training shape (b 2, s 2048, h 48, p 64,
// n 128, chunk 256), three times over in 3xTF32 against ~0.2 GB of inputs
// and outputs: the operations bound it (chip_smoke.py's ssd_bwd_bound_ms).
// What the design does about that: the same 3xTF32 mma.sync products as the
// forward (ssd_common.cuh; plain TF32 misses the forward's 2e-3 tolerance),
// C B^T read from the forward's scratch instead of recomputed, and the
// upper triangle of each chunk skipped at 64-row tile granularity. It is a
// first design: single-buffered cp.async tiles, dy x^T computed by both
// kernels 3 and 4, and the heads' shares of dB and dC (b,h,s,n) written out
// and summed by kernel 6. Its times are in PERF.md.
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

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// Shared-memory layouts: rows padded to 4 mod 32 floats where a fragment
// walks a row, 8 mod 32 where it walks a column (bank-conflict-free)
template <int P, int NK>
struct Tiles {
  static constexpr int MQ = (NK + 63) / 64;     // m-tiles a warp of the dstate kernel
  static constexpr int LDC = MQ * 64 + 8;       // dstate: C, walked down its columns
  static constexpr int LDY = P + 8;             // dstate: dy, walked down its columns
  static constexpr int LDP = P + 4;             // x, dy, S_prev, dS_out
  static constexpr int LDA = NK + 4;            // B of the j-tile as an A operand
  static constexpr int LDB = NK + 8;            // B or C as a B operand, walked down
  static constexpr int LDT = TQ + 4;            // P, M^T, P^T tiles
  static constexpr int REGION = cmax(NK * LDP, TQ * (LDP + LDB));
  static constexpr size_t dstate_bytes = sizeof(float) * (TQ * LDC + TQ * LDY + TQ);
  static constexpr size_t dc_bytes = sizeof(float) * (TQ * LDP + REGION + TQ * LDT + 5 * TQ);
  static constexpr size_t dx_bytes =
      sizeof(float) * (TQ * LDP + TQ * LDA + REGION + 2 * TQ * LDT + 8 * TQ);
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
  float* cs = reinterpret_cast<float*>(smem4);  // (TQ, LDC) C, columns past n zero
  float* dys = cs + TQ * T::LDC;                // (TQ, LDY)
  float* es = dys + TQ * T::LDY;                // (TQ) exp(cum_i), 0 past the chunk

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int qv = valid_rows(d, c);

  // (n, P) = sum over the chunk's rows of (exp(cum) C)^T dy: M = n (m-tiles
  // wm, wm + 4), N = P (warp wn takes P/2 columns), K = rows
  float acc[MQ][NTP][4] = {};
  for (int i0 = 0; i0 < qv; i0 += TQ) {
    load_rows<BW_THREADS>(cs, T::LDC, C, d, bb, c, i0, TQ, d.n, MQ * 64, d.n, 0);
    load_rows<BW_THREADS>(dys, T::LDY, dy, d, bb, c, i0, TQ, P, P, (size_t)d.h * P,
                          (size_t)hh * P);
    cp_commit();
    if (tid < TQ) es[tid] = i0 + tid < qv ? expf(cum_g[bhc * d.Q + i0 + tid]) : 0.f;
    cp_wait<0>();
    __syncthreads();
    gemm<TQ, MQ, NTP>(
        acc, g, t, [&](int q, int r, int k) { return cs[k * T::LDC + (wm + 4 * q) * 16 + r] * es[k]; },
        [&](int k, int col) { return dys[k * T::LDY + wn * (P / 2) + col]; });
    __syncthreads();                       // the tiles are consumed
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
                          const float* __restrict__ cum_g, int nc, int Q, int np4) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= np4) return;
  const size_t bh = blockIdx.y;
  float4* st = reinterpret_cast<float4*>(dstates + bh * nc * (size_t)np4 * 4) + e;
  float4 run = ds_final ? reinterpret_cast<const float4*>(ds_final + bh * (size_t)np4 * 4)[e]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const float g = expf(cum_g[(bh * nc + c) * Q + Q - 1]);   // the chunk's decay
    const float4 own = st[(size_t)c * np4];
    st[(size_t)c * np4] = run;
    run = make_float4(g * run.x + own.x, g * run.y + own.y, g * run.z + own.z,
                      g * run.w + own.w);
  }
}

// ---------------------------------------------------------------------------
// 3. per (b, h, chunk, i-tile): this head's dC_i and dcum's row sums
// ---------------------------------------------------------------------------

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ B, const float* __restrict__ C,
                  const float* __restrict__ dy, const float* __restrict__ cum_g,
                  const float* __restrict__ states, const float* __restrict__ cb,
                  float* __restrict__ dCh, float* __restrict__ rowp, Dims d) {
  using T = Tiles<P, NK>;
  constexpr int NTN = NK / 16, NTJ = TQ / 16;   // n-tiles of a warp over n, over j
  extern __shared__ float4 smem4[];
  float* dys = reinterpret_cast<float*>(smem4);  // (TQ, LDP) dy of the i-tile
  float* sps = dys + TQ * T::LDP;                // (NK, LDP) S_prev, first; then
  float* xs = sps;                               // (TQ, LDP) x of a j-tile and
  float* bs = xs + TQ * T::LDP;                  // (TQ, LDB) B of a j-tile
  float* ps = sps + T::REGION;                   // (TQ, LDT) P
  float* cum_i = ps + TQ * T::LDT;               // (TQ)
  float* cum_j = cum_i + TQ;                     // (TQ)
  float* w_j = cum_j + TQ;                       // (TQ)
  float* rowacc = w_j + TQ;                      // (2, TQ) row sums of each column half

  const int c = blockIdx.x / d.ntile;
  const int it = d.ntile - 1 - blockIdx.x % d.ntile;   // heaviest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp >> 1) * 16, wn = warp & 1;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int i0 = it * TQ, qv = valid_rows(d, c);
  if (i0 >= qv) return;                    // the ragged chunk's empty tiles
  const size_t xstride = (size_t)d.h * P;
  const float* cbc = cb + ((size_t)bb * d.nc + c) * d.Qp * d.Qp;

  load_rows<BW_THREADS>(dys, T::LDP, dy, d, bb, c, i0, TQ, P, P, xstride, (size_t)hh * P);
  load_state<P, NK>(sps, T::LDP, states + bhc * d.n * P, d.n);
  cp_commit();
  if (tid < TQ) cum_i[tid] = i0 + tid < qv ? cum_g[bhc * d.Q + i0 + tid] : 0.f;
  cp_wait<0>();
  __syncthreads();

  // dC_i = exp(cum_i) dy_i S_prev^T; the row sums start with
  // exp(cum_i) C_i . (dy_i S_prev^T)
  float acc[1][NTN][4] = {};
  gemm<P, 1, NTN>(
      acc, g, t, [&](int, int r, int k) { return dys[(r0 + r) * T::LDP + k]; },
      [&](int k, int col) { return sps[(wn * (NK / 2) + col) * T::LDP + k]; });
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half, li = i0 + r;
    const bool ok = li < qv;
    const float e = ok ? expf(cum_i[r]) : 0.f;
    const float* crow = C + ((size_t)bb * d.s + (size_t)c * d.Q + (ok ? li : 0)) * d.n;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      if (ok && col < d.n) {
        const float2 cv = *reinterpret_cast<const float2*>(crow + col);
        rsum[half] += cv.x * acc[0][nt][2 * half] + cv.y * acc[0][nt][2 * half + 1];
      }
      acc[0][nt][2 * half] *= e;
      acc[0][nt][2 * half + 1] *= e;
    }
    rsum[half] *= e;
  }
  __syncthreads();                         // S_prev is consumed

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TQ;
    load_rows<BW_THREADS>(xs, T::LDP, x, d, bb, c, j0, TQ, P, P, xstride, (size_t)hh * P);
    load_rows<BW_THREADS>(bs, T::LDB, B, d, bb, c, j0, TQ, d.n, NK, d.n, 0);
    cp_commit();
    if (tid < TQ) {
      const bool ok = j0 + tid < qv;
      cum_j[tid] = ok ? cum_g[bhc * d.Q + j0 + tid] : 0.f;
      w_j[tid] = ok ? dt[((size_t)bb * d.s + (size_t)c * d.Q + j0 + tid) * d.h + hh] : 0.f;
    }
    cp_wait<0>();
    __syncthreads();
    // G = dy_i x_j^T; P = G w_j L on the causal mask; T's row sums C B^T P
    float gacc[1][NTJ][4] = {};
    gemm<P, 1, NTJ>(
        gacc, g, t, [&](int, int r, int k) { return dys[(r0 + r) * T::LDP + k]; },
        [&](int k, int col) { return xs[(wn * (TQ / 2) + col) * T::LDP + k]; });
#pragma unroll
    for (int nt = 0; nt < NTJ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), col = wn * (TQ / 2) + nt * 8 + 2 * t + (e & 1);
        const int li = i0 + r, lj = j0 + col;
        float pv = 0.f;
        if (lj <= li && li < qv) {
          pv = gacc[0][nt][e] * w_j[col] * expf(cum_i[r] - cum_j[col]);
          rsum[e >> 1] += cbc[(size_t)li * d.Qp + lj] * pv;
        }
        ps[r * T::LDT + col] = pv;
      }
    __syncthreads();
    // dC_i += P B_j
    gemm<TQ, 1, NTN>(
        acc, g, t, [&](int, int r, int k) { return ps[(r0 + r) * T::LDT + k]; },
        [&](int k, int col) { return bs[k * T::LDB + wn * (NK / 2) + col]; });
    __syncthreads();                       // x_j, B_j and P are consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float v = quad_sum(rsum[half]);
    if (t == 0) rowacc[wn * TQ + r0 + g + 8 * half] = v;
  }
  float* out = dCh + (((size_t)bb * d.h + hh) * d.s + (size_t)c * d.Q + i0) * d.n;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (i0 + r >= qv) continue;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      if (col < d.n)
        *reinterpret_cast<float2*>(out + (size_t)r * d.n + col) =
            make_float2(acc[0][nt][2 * half], acc[0][nt][2 * half + 1]);
    }
  }
  __syncthreads();
  if (tid < TQ && i0 + tid < qv) rowp[bhc * d.Q + i0 + tid] = rowacc[tid] + rowacc[TQ + tid];
}

// ---------------------------------------------------------------------------
// 4. per (b, h, chunk, j-tile): dx_j, this head's dB_j, dw_j, dcum's column
//    sums and u_j
// ---------------------------------------------------------------------------

template <int P, int NK>
__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ B, const float* __restrict__ C,
                  const float* __restrict__ dy, const float* __restrict__ cum_g,
                  const float* __restrict__ dstates, const float* __restrict__ cb,
                  float* __restrict__ dx, float* __restrict__ dBh, float* __restrict__ colp,
                  float* __restrict__ dw, float* __restrict__ u, Dims d) {
  using T = Tiles<P, NK>;
  constexpr int NTN = NK / 16, NTP = P / 16, NTI = TQ / 16;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (TQ, LDP) x of the j-tile
  float* bsj = xs + TQ * T::LDP;                // (TQ, LDA) B of the j-tile
  float* dso = bsj + TQ * T::LDA;               // (NK, LDP) dS_out, first; then
  float* dys = dso;                             // (TQ, LDP) dy of an i-tile and
  float* cs = dys + TQ * T::LDP;                // (TQ, LDB) C of an i-tile
  float* mts = dso + T::REGION;                 // (TQ, LDT) M^T
  float* pts = mts + TQ * T::LDT;               // (TQ, LDT) P^T
  float* cum_j = pts + TQ * T::LDT;             // (TQ)
  float* w_j = cum_j + TQ;                      // (TQ)
  float* e_j = w_j + TQ;                        // (TQ) exp(cum_Q - cum_j)
  float* cum_i = e_j + TQ;                      // (TQ)
  float* rowacc = cum_i + TQ;                   // (2 sums, 2 column halves, TQ)

  const int c = blockIdx.x / d.ntile;
  const int jt = blockIdx.x % d.ntile;         // heaviest tiles (most i-tiles) first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = (warp >> 1) * 16, wn = warp & 1;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int j0 = jt * TQ, qv = valid_rows(d, c);
  if (j0 >= qv) return;                    // the ragged chunk's empty tiles
  const size_t xstride = (size_t)d.h * P;
  const float* cbc = cb + ((size_t)bb * d.nc + c) * d.Qp * d.Qp;

  load_rows<BW_THREADS>(xs, T::LDP, x, d, bb, c, j0, TQ, P, P, xstride, (size_t)hh * P);
  load_rows<BW_THREADS>(bsj, T::LDA, B, d, bb, c, j0, TQ, d.n, NK, d.n, 0);
  load_state<P, NK>(dso, T::LDP, dstates + bhc * d.n * P, d.n);
  cp_commit();
  if (tid < TQ) {
    const bool ok = j0 + tid < qv;
    const float cq = cum_g[bhc * d.Q + d.Q - 1], cj = ok ? cum_g[bhc * d.Q + j0 + tid] : 0.f;
    cum_j[tid] = cj;
    w_j[tid] = ok ? dt[((size_t)bb * d.s + (size_t)c * d.Q + j0 + tid) * d.h + hh] : 0.f;
    e_j[tid] = ok ? expf(cq - cj) : 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  // the state terms: dx starts at exp(cum_Q - cum_j) B_j dS_out, dB at
  // exp(cum_Q - cum_j) w_j x_j dS_out^T; sst = exp(cum_Q - cum_j) (B_j dS_out) . x_j
  float dxa[1][NTP][4] = {}, dba[1][NTN][4] = {};
  gemm<NK, 1, NTP>(
      dxa, g, t, [&](int, int r, int k) { return bsj[(r0 + r) * T::LDA + k]; },
      [&](int k, int col) { return dso[k * T::LDP + wn * (P / 2) + col]; });
  gemm<P, 1, NTN>(
      dba, g, t, [&](int, int r, int k) { return xs[(r0 + r) * T::LDP + k]; },
      [&](int k, int col) { return dso[(wn * (NK / 2) + col) * T::LDP + k]; });
  float sst[2] = {0.f, 0.f}, dwi[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const float e = e_j[r], ew = e * w_j[r];
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      const int col = wn * (P / 2) + nt * 8 + 2 * t;
      sst[half] += dxa[0][nt][2 * half] * xs[r * T::LDP + col] +
                   dxa[0][nt][2 * half + 1] * xs[r * T::LDP + col + 1];
      dxa[0][nt][2 * half] *= e;
      dxa[0][nt][2 * half + 1] *= e;
    }
    sst[half] *= e;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      dba[0][nt][2 * half] *= ew;
      dba[0][nt][2 * half + 1] *= ew;
    }
  }
  __syncthreads();                         // dS_out is consumed

  for (int it = jt; it < d.ntile; ++it) {
    const int i0 = it * TQ;
    if (i0 >= qv) break;
    load_rows<BW_THREADS>(dys, T::LDP, dy, d, bb, c, i0, TQ, P, P, xstride, (size_t)hh * P);
    load_rows<BW_THREADS>(cs, T::LDB, C, d, bb, c, i0, TQ, d.n, NK, d.n, 0);
    cp_commit();
    if (tid < TQ) cum_i[tid] = i0 + tid < qv ? cum_g[bhc * d.Q + i0 + tid] : 0.f;
    cp_wait<0>();
    __syncthreads();
    // G^T = x_j dy_i^T (rows j, columns i); M^T and P^T on the causal mask
    float gacc[1][NTI][4] = {};
    gemm<P, 1, NTI>(
        gacc, g, t, [&](int, int r, int k) { return xs[(r0 + r) * T::LDP + k]; },
        [&](int k, int col) { return dys[(wn * (TQ / 2) + col) * T::LDP + k]; });
#pragma unroll
    for (int nt = 0; nt < NTI; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), col = wn * (TQ / 2) + nt * 8 + 2 * t + (e & 1);
        const int lj = j0 + r, li = i0 + col;
        float mv = 0.f, pv = 0.f;
        if (lj <= li && li < qv) {
          const float l = expf(cum_i[col] - cum_j[r]);
          mv = cbc[(size_t)li * d.Qp + lj] * l;
          pv = gacc[0][nt][e] * w_j[r] * l;
          dwi[e >> 1] += mv * gacc[0][nt][e];
        }
        mts[r * T::LDT + col] = mv;
        pts[r * T::LDT + col] = pv;
      }
    __syncthreads();
    // dx_j += M^T dy_i; dB_j += P^T C_i
    gemm<TQ, 1, NTP>(
        dxa, g, t, [&](int, int r, int k) { return mts[(r0 + r) * T::LDT + k]; },
        [&](int k, int col) { return dys[k * T::LDP + wn * (P / 2) + col]; });
    gemm<TQ, 1, NTN>(
        dba, g, t, [&](int, int r, int k) { return pts[(r0 + r) * T::LDT + k]; },
        [&](int k, int col) { return cs[k * T::LDB + wn * (NK / 2) + col]; });
    __syncthreads();                       // dy_i, C_i, M^T and P^T are consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float s = quad_sum(sst[half]), di = quad_sum(dwi[half]);
    if (t == 0) {
      rowacc[wn * TQ + r0 + g + 8 * half] = s;
      rowacc[(2 + wn) * TQ + r0 + g + 8 * half] = di;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half, lj = j0 + r;
    if (lj >= qv) continue;
    const size_t row = (size_t)bb * d.s + (size_t)c * d.Q + lj;
    const float w = w_j[r];
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt)
      *reinterpret_cast<float2*>(dx + row * xstride + (size_t)hh * P + wn * (P / 2) + nt * 8 +
                                 2 * t) =
          make_float2(w * dxa[0][nt][2 * half], w * dxa[0][nt][2 * half + 1]);
    float* out = dBh + (((size_t)bb * d.h + hh) * d.s + (size_t)c * d.Q + lj) * d.n;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const int col = wn * (NK / 2) + nt * 8 + 2 * t;
      if (col < d.n)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(dba[0][nt][2 * half], dba[0][nt][2 * half + 1]);
    }
  }
  __syncthreads();
  if (tid < TQ && j0 + tid < qv) {
    const float st = rowacc[tid] + rowacc[TQ + tid];
    const float di = rowacc[2 * TQ + tid] + rowacc[3 * TQ + tid];
    const size_t o = bhc * d.Q + j0 + tid;
    const float uj = w_j[tid] * st;
    dw[o] = di + st;
    u[o] = uj;
    colp[o] = w_j[tid] * di + uj;
  }
}

// ---------------------------------------------------------------------------
// 5. per (b, h, chunk): dcum, da (its reverse cumsum), ddt and dA's share
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BW_THREADS)
ssd_bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ cum_g, const float* __restrict__ states,
                  const float* __restrict__ dstates, const float* __restrict__ rowp,
                  const float* __restrict__ colp, const float* __restrict__ dw,
                  const float* __restrict__ u, float* __restrict__ ddt,
                  float* __restrict__ dapart, int P, Dims d) {
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
  float sp = 0.f;                          // <dS_out, S_prev>
  const float4* a4 = reinterpret_cast<const float4*>(dstates + bhc * d.n * P);
  const float4* b4 = reinterpret_cast<const float4*>(states + bhc * d.n * P);
  for (int e = tid; e < d.n * P / 4; e += BW_THREADS) {
    const float4 a = a4[e], b = b4[e];
    sp += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  sp = block_sum<BW_THREADS>(sp, red);
  for (int r = tid; r < d.Q; r += BW_THREADS) dcum[r] = r < qv ? rowp[rb + r] - colp[rb + r] : 0.f;
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
// 6. dB, dC: the heads' shares summed in head order; 7. dA: the chunks' shares
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_sum_heads_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh,
                         float* __restrict__ dB, float* __restrict__ dC, int h, int sn4) {
  const int e = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= sn4) return;
  const size_t bb = blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(blockIdx.z ? dCh : dBh) +
                      bb * h * (size_t)sn4 + e;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int hh = 0; hh < h; ++hh) {
    const float4 v = src[(size_t)hh * sn4];
    acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  reinterpret_cast<float4*>(blockIdx.z ? dC : dB)[bb * sn4 + e] = acc;
}

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
  float *dstates, *dBh, *dCh, *rowp, *colp, *dw, *u, *dapart;
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
cudaError_t launch(const Args& a, const Dims& d, cudaStream_t st) {
  using T = Tiles<P, NK>;
  static unsigned long long dstate_ready = 0, dc_ready = 0, dx_ready = 0;
  cudaError_t err;
  if ((err = smem_limit_once(ssd_bwd_dstate_kernel<P, NK>, T::dstate_bytes, dstate_ready)) !=
          cudaSuccess ||
      (err = smem_limit_once(ssd_bwd_dc_kernel<P, NK>, T::dc_bytes, dc_ready)) != cudaSuccess ||
      (err = smem_limit_once(ssd_bwd_dx_kernel<P, NK>, T::dx_bytes, dx_ready)) != cudaSuccess)
    return err;
  const dim3 per_chunk(d.nc, d.h, d.b), per_tile(d.nc * d.ntile, d.h, d.b);
  ssd_bwd_dstate_kernel<P, NK><<<per_chunk, BW_THREADS, T::dstate_bytes, st>>>(
      a.C, a.dy, a.cum, a.dstates, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np4 = d.n * P / 4;
  ssd_bwd_state_pass_kernel<<<dim3((np4 + PASS_THREADS - 1) / PASS_THREADS, d.b * d.h),
                              PASS_THREADS, 0, st>>>(a.dstates, a.ds_final, a.cum, d.nc, d.Q,
                                                     np4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dc_kernel<P, NK><<<per_tile, BW_THREADS, T::dc_bytes, st>>>(
      a.x, a.dt, a.B, a.C, a.dy, a.cum, a.states, a.cb, a.dCh, a.rowp, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dx_kernel<P, NK><<<per_tile, BW_THREADS, T::dx_bytes, st>>>(
      a.x, a.dt, a.B, a.C, a.dy, a.cum, a.dstates, a.cb, a.dx, a.dBh, a.colp, a.dw, a.u, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_dt_kernel<<<per_chunk, BW_THREADS, sizeof(float) * d.Q, st>>>(
      a.dt, a.A, a.cum, a.states, a.dstates, a.rowp, a.colp, a.dw, a.u, a.ddt, a.dapart, P, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int sn4 = d.s * d.n / 4;
  ssd_bwd_sum_heads_kernel<<<dim3((sn4 + SUM_THREADS - 1) / SUM_THREADS, d.b, 2), SUM_THREADS,
                             0, st>>>(a.dBh, a.dCh, a.dB, a.dC, d.h, sn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_da_kernel<<<(d.h + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(a.dapart,
                                                                                  a.dA, d);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_p(const Args& a, const Dims& d, cudaStream_t st) {
  if (d.n <= 16) return launch<P, 16>(a, d, st);
  if (d.n <= 32) return launch<P, 32>(a, d, st);
  if (d.n <= 64) return launch<P, 64>(a, d, st);
  return launch<P, 128>(a, d, st);
}

}  // namespace

extern "C" {

// Inputs as ssd_fwd took them (x (b,s,h,p), dt (b,s,h), A (h,), B/C
// (b,s,n)), dy (b,s,h,p), ds_final (b,h,n,p) or null, and ssd_fwd's
// scratch after its call: states (b,h,nc,n,p), cum (b,h,nc,Q) and cb
// (b,nc,Qp,Qp). Writes dx (b,s,h,p), ddt (b,s,h), dA (h,), dB and dC
// (b,s,n). Scratch from the caller: dstates (b,h,nc,n,p), dBh and dCh
// (b,h,s,n), rowp, colp, dw and u (b,h,nc,Q), dapart (b,h,nc). All f32,
// contiguous, 16-byte aligned, on the current device; chunk = min(chunk, s)
// as the forward took it, p in {16, 32, 64}, n a multiple of 4 up to 128.
// Launches the seven kernels on `stream` without synchronising; returns the
// first launch error (cudaGetLastError()), or cudaErrorInvalidValue.
int ssd_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
            const void* dy, const void* ds_final, const void* states, const void* cum,
            const void* cb, void* dx, void* ddt, void* dA, void* dB, void* dC, void* dstates,
            void* dBh, void* dCh, void* rowp, void* colp, void* dw, void* u, void* dapart, int b,
            int s, int h, int p, int n, int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 || n <= 0 || n % 4 ||
      n > MAX_N || chunk <= 0 || chunk > MAX_CHUNK || chunk > s)
    return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk, ntile = (chunk + TQ - 1) / TQ;
  Dims d{b, s, h, n, (n + 15) / 16 * 16, chunk, nc, ntile, ntile * TQ};
  if ((long long)nc * ntile > 0x7fffffffLL || (long long)b * h > 65535 || nc > 65535)
    return cudaErrorInvalidValue;
  auto in = [](const void* v) { return static_cast<const float*>(v); };
  auto out = [](void* v) { return static_cast<float*>(v); };
  const Args a{in(x),      in(dt),      in(A),     in(B),       in(C),     in(dy),
               in(ds_final), in(states), in(cum),   in(cb),      out(dx),   out(ddt),
               out(dA),    out(dB),     out(dC),   out(dstates), out(dBh), out(dCh),
               out(rowp),  out(colp),   out(dw),   out(u),      out(dapart)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 16: return launch_p<16>(a, d, st);
    case 32: return launch_p<32>(a, d, st);
    case 64: return launch_p<64>(a, d, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
