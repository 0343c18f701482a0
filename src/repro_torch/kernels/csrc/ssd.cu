// Mamba2 SSD (state-space duality) forward for Hopper (sm_90a), f32 in and
// out, every product on the tensor cores in 3xTF32, with a plain C interface
// (loaded from Python with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py::ssd_tpu (Pallas, body
// `_kernel`) and computes the same function:
//   x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n) shared by all heads
//   -> y (b,s,h,p), S_final (b,h,n,p), everything f32.
//   The sequence is cut into chunks of Q = min(chunk, s) rows (the last one
//   ragged); within a chunk cum = cumsum(dt * A) and
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S_prev,
//     S  <- exp(cum_last) S_prev + sum_j B_j dt_j exp(cum_last - cum_j) x_j^T.
//   exp(cum_i - cum_j) overflows above the diagonal, so the mask selects
//   and never multiplies. Rows past s are masked (dt = 0, x = B = C = 0):
//   they leave S unchanged and are not written, as the TPU kernel's padding.
//
// The TPU walks the chunks in order on its sequential grid axis and carries
// S in VMEM scratch. Blocks on the card run in no order, so one call is the
// decomposition of arXiv:2405.21060, SS6, as four kernels on one stream:
//   1. ssd_cb_kernel, one block per (b, chunk, 64x64 tile pair j <= i):
//      C_i B_j^T over n, once for all heads, into the scratch cb
//      (b, nc, Qp, Qp), Qp = Q rounded up to 64 (8.4 MB at the serving
//      shape, read by the 48 heads out of L2);
//   2. ssd_chunk_state_kernel, one block per (b, h, chunk): the chunk's cum
//      (block scan), its decay exp(cum_last) and its own state
//      (B o w)^T x from zero, w_j = dt_j exp(cum_last - cum_j);
//   3. ssd_state_pass_kernel, elementwise over (b, h, n*p): walks the chunks
//      in order and turns each chunk's own state into the state entering it
//      (S_prev), and writes S_final;
//   4. ssd_chunk_out_kernel, one block per (b, h, chunk, 64-row i-tile):
//      exp(cum_i) C_i . S_prev, then for each 64-row j-tile with j <= i the
//      scores exp(cum_i - cum_j) dt_j (C B^T)_ij, selected on the causal
//      mask, times x_j. The wrapper counts the four as one launch.
//
// What bounds it: at the serving shape (b 4, s 2048, h 48, p 64, n 128,
// chunk 256) the function needs ~1.96e10 FLOP (the causal half of C B^T once
// per (b, chunk), the causal half of scores . x, C . S_prev and the state
// update per (b, h, chunk)) against ~0.22 GB of inputs and outputs. f32
// accuracy from TF32 tensor cores takes three products per product
// (3xTF32), 5.9e10 TF32 FLOP: 0.119 ms at 495 TFLOP/s against 0.065 ms for
// the bytes at 3.35 TB/s, so the operations bound it (0.2925 ms at the f32
// rate without tensor cores).
// What the design does about that:
//   * every product is mma.sync m16n8k8 TF32 with each operand split as
//     big = cvt.rn.tf32(a), small = cvt.rn.tf32(a - big) and the sum
//     small.big + big.small + big.big accumulated in f32 (CUTLASS's
//     OpMultiplyAddFastF32). Plain TF32 misses the 2e-3 sweep tolerance
//     (3.8e-3 - 5.7e-3); the split is within f32's error
//     (tests/test_torch_ssd.py emulates both). cvt.rn is one F2FP
//     instruction on sm_90; cvt.rna (ties away) is three with an inf guard;
//   * C B^T is computed once per (b, chunk), not per head: 1/48 of the
//     ~16 GFLOP of it that a per-head computation takes;
//   * the upper triangle is skipped at MMA granularity: the CB kernel skips
//     16x8 tiles above the diagonal, and on the diagonal tile the output
//     kernel's warps stop at the end of their 32 rows (rows 0-31 after
//     k-step 3). A warp holds two 16-row m-tiles that share each B
//     fragment, so it skips 32 rows at a time, not 16: stopping its first
//     m-tile 16 rows earlier would save 1/6 of the diagonal tile's
//     products, about 3% of the kernel's, and the kernel is held by its
//     loads more than by its products (below);
//   * the output kernel's exponentials, exp(cum_i) and exp(cum_i - cum_j),
//     are ex2.approx.ftz of the argument times log2 e (2 ulp; the other
//     kernels use expf). The CPU emulation in tests/test_torch_ssd.py uses
//     an exact exp, so only the card run checks this: the serving-shape
//     error is 6.7e-4 at max |ref| 103 (6.5e-4 for the earlier f32-FMA
//     kernel, which used expf);
//   * tiles are loaded with cp.async (zero-filled past the chunk, the
//     sequence and n, so the wrapper copies nothing), double-buffered where
//     a loop walks tiles;
//     the output kernel's A tiles (C, or C B^T turned into scores) go
//     through registers, fetched a step ahead while the tensor cores work;
//   * shared-memory rows are padded so that every fragment load is free of
//     bank conflicts: 4 mod 8 floats where the fragment walks a row (M- or
//     N-major), 8 mod 16 where it walks a column (K-major);
//   * the heaviest i-tiles (most j-tiles) are launched first.
// Measured (NVIDIA H100 80GB HBM3, 700 W, scripts/ssd_vs_parent.py, PERF.md):
// 0.60 ms a call against the earlier f32-FMA kernel's 1.65 in one process
// (CUDA events around one call, its host time included); device time: the
// output kernel 0.297, the state kernel 0.155, the state pass 0.053, C B^T
// 0.017. The output kernel is not held by its products: with one TF32
// product instead of three it takes 0.23 ms, with none 0.15 (its loads,
// ~0.58 MB from L2 per (b, h, chunk), and their latency).
// Tried and dropped (same card and script, then timing 5 calls a CUDA-event
// pair, where this kernel took 0.55 ms):
// cvt.rna splits (0.89 ms); the three passes of all tiles in turn instead of
// a tile's three in a row (no change); operands split once into shared
// memory as (big, small) pairs (0.80 ms: registers spill, twice the shared
// bytes); wgmma m64n64k8 TF32 for the output kernel as y^T = x^T . scores^T,
// so that both operands are K-major: with A from registers 0.35 ms for that
// kernel, with both from shared memory (x transposed and split as it is
// stored) 0.41-0.61 ms (N = 32 halves on the diagonal tile make ptxas
// serialise the wgmmas; without them 2 blocks an SM fit, and the staging
// between steps, not the tensor cores, takes the time); 128-row i-tiles
// (0.31 ms for that kernel: fewer bytes, no more warps an SM).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_common.cuh"

namespace {

constexpr int TQ = 64;           // rows of an i-tile or a j-tile of C B^T and y
constexpr int TJ = 64;           // rows of a j-tile of the state kernel
constexpr int MAX_CHUNK = 4096;  // the chunk's cum lives in shared memory
constexpr int MAX_N = 256;
constexpr int LDP_PAD = 4;       // scores tile: 64 + 4 floats a row
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// 1. per (b, chunk, tile pair): cb = C_i B_j^T, once for all heads
// ---------------------------------------------------------------------------

constexpr int CB_THREADS = 128;  // 2 x 2 warps of 32 x 32

__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C, float* __restrict__ cb,
              Dims d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d.nk + 4;                 // A and B fragments walk rows
  float* Cs = smem;                        // (TQ, ld) rows of C of the i-tile
  float* Bs = Cs + TQ * ld;                // (TQ, ld) rows of B of the j-tile

  // pair -> (it, jt), jt <= it, pairs in row order of the lower triangle
  const int pair = blockIdx.x, c = blockIdx.y, bb = blockIdx.z;
  int it = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  while (it * (it + 1) / 2 > pair) --it;
  const int jt = pair - it * (it + 1) / 2;
  const int i0 = it * TQ, j0 = jt * TQ;
  if (i0 >= valid_rows(d, c)) return;      // the ragged chunk's empty tiles

  load_rows<CB_THREADS>(Cs, ld, C, d, bb, c, i0, TQ, d.n, d.nk, d.n, 0);
  load_rows<CB_THREADS>(Bs, ld, B, d, bb, c, j0, TQ, d.n, d.nk, d.n, 0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const bool diag = it == jt;
  // a 16 x 8 tile (rows r0.., columns c0..) is above the diagonal when c0 > r0 + 15
  auto live = [&](int mt, int nt) {
    return !diag || wn * 32 + nt * 8 <= wm * 32 + mt * 16 + 15;
  };
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < d.nk; k0 += 8) {
    uint32_t ab[2][4], as[2][4], bbig[4][2], bsml[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float* base = Cs + (wm * 32 + mt * 16) * ld + k0;
      load_a(ab[mt], as[mt], g, t, [&](int r, int k) { return base[r * ld + k]; });
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* base = Bs + (wn * 32 + nt * 8) * ld + k0;
      load_b(bbig[nt], bsml[nt], g, t, [&](int k, int col) { return base[col * ld + k]; });
    }
    if (!diag) {
      mma3(acc, ab, as, bbig, bsml);
      continue;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (live(mt, nt)) {
          mma_tf32(acc[mt][nt], as[mt], bbig[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bsml[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bbig[nt]);
        }
  }
  float* out = cb + (((size_t)bb * d.nc + c) * d.Qp + i0) * d.Qp + j0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (!live(mt, nt)) continue;
      const int r = wm * 32 + mt * 16 + g, col = wn * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (size_t)r * d.Qp + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * d.Qp + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// 2. per (b, h, chunk): cum, decay and the chunk's own state
// ---------------------------------------------------------------------------

constexpr int ST_THREADS = 256;  // 4 x 2 warps over (n, p)
constexpr int ST_WARPS = ST_THREADS / 32;

// MQ m-tiles a warp: the state's rows are padded to MQ * 64 >= n in shared
// memory (zeros), so every warp runs the same products without a branch
template <int P, int MQ>
__global__ void __launch_bounds__(ST_THREADS)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ cum_g, float* __restrict__ decay,
                       float* __restrict__ states, Dims d) {
  constexpr int LDX = P + 8;               // B fragments walk columns of x
  constexpr int NT = P / 16;               // 8-column n-tiles of a warp
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NS = MQ * 64;              // rows of the state, padded
  constexpr int ldb = NS + 8;              // A fragments walk columns of B
  const int qw = (d.Q + TJ - 1) / TJ * TJ;
  float* Bs = smem;                        // 2 x (TJ, ldb)
  float* xs = Bs + 2 * TJ * ldb;           // 2 x (TJ, LDX)
  float* warp_tot = xs + 2 * TJ * LDX;     // (ST_WARPS)
  float* cum = warp_tot + ST_WARPS;        // (qw): cum, then w

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int qv = valid_rows(d, c);
  const float Ah = A[hh];
  auto dt_at = [&](int r) { return dt[((size_t)bb * d.s + (size_t)c * d.Q + r) * d.h + hh]; };

  // inclusive block scan of dt * A over the chunk's rows
  float carry = 0.f;
  for (int base = 0; base < d.Q; base += ST_THREADS) {
    const int r = base + tid;
    float v = r < qv ? dt_at(r) * Ah : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < ST_WARPS ? warp_tot[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < ST_WARPS; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < ST_WARPS) warp_tot[lane] = w;
    }
    __syncthreads();
    if (r < d.Q) cum[r] = carry + (warp ? warp_tot[warp - 1] : 0.f) + v;
    carry += warp_tot[ST_WARPS - 1];
    __syncthreads();
  }
  for (int r = tid; r < d.Q; r += ST_THREADS) cum_g[bhc * d.Q + r] = cum[r];
  const float cum_last = cum[d.Q - 1];
  if (tid == 0) decay[bhc] = expf(cum_last);
  __syncthreads();
  // cum -> w_j = dt_j exp(cum_last - cum_j) in place, 0 past the valid rows
  for (int r = tid; r < qw; r += ST_THREADS)
    cum[r] = r < qv ? dt_at(r) * expf(cum_last - cum[r]) : 0.f;

  // state (n, P) = sum_j B_j^T (w_j x_j): M = n (m-tiles wm, wm + 4, ...),
  // N = P (warp wn takes P/2 columns), K = the chunk's rows
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int ntj = (qv + TJ - 1) / TJ;
  auto load = [&](int jt) {
    const int buf = jt & 1;
    load_rows<ST_THREADS>(Bs + buf * TJ * ldb, ldb, B, d, bb, c, jt * TJ, TJ, d.n, NS, d.n, 0);
    load_rows<ST_THREADS>(xs + buf * TJ * LDX, LDX, x, d, bb, c, jt * TJ, TJ, P, P,
                          (size_t)d.h * P, (size_t)hh * P);
    cp_commit();
  };
  float acc[MQ][NT][4] = {};
  load(0);
  for (int jt = 0; jt < ntj; ++jt) {
    if (jt + 1 < ntj) {
      load(jt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                       // tile jt and the w's are in place
    const float* Bt = Bs + (jt & 1) * TJ * ldb;
    const float* xt = xs + (jt & 1) * TJ * LDX;
    const float* wt = cum + jt * TJ;
#pragma unroll
    for (int k0 = 0; k0 < TJ; k0 += 8) {
      uint32_t bbig[NT][2], bsml[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* base = xt + k0 * LDX + wn * (P / 2) + nt * 8;
        load_b(bbig[nt], bsml[nt], g, t,
               [&](int k, int col) { return base[k * LDX + col] * wt[k0 + k]; });
      }
      uint32_t ab[MQ][4], as[MQ][4];
#pragma unroll
      for (int q = 0; q < MQ; ++q) {
        const float* base = Bt + k0 * ldb + (wm + 4 * q) * 16;
        load_a(ab[q], as[q], g, t, [&](int r, int k) { return base[k * ldb + r]; });
      }
      mma3(acc, ab, as, bbig, bsml);
    }
    __syncthreads();                       // tile jt is consumed
  }
  float* out = states + bhc * d.n * P;
#pragma unroll
  for (int q = 0; q < MQ; ++q) {
    const int r = (wm + 4 * q) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
// 3. per (b, h): chunk states -> state entering each chunk, and S_final
// ---------------------------------------------------------------------------

constexpr int PASS_THREADS = 256;
constexpr int PASS_BATCH = 8;    // chunks whose loads are in flight at once

__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      float* __restrict__ s_final, int nc, int np4) {
  const int e = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e >= np4) return;
  const size_t bh = blockIdx.y;
  float4* st = reinterpret_cast<float4*>(states + bh * nc * (size_t)np4 * 4) + e;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 own[PASS_BATCH];
    float g[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) {
        own[k] = st[(size_t)(c0 + k) * np4];
        g[k] = decay[bh * nc + c0 + k];
      }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k)
      if (c0 + k < nc) {
        st[(size_t)(c0 + k) * np4] = run;
        run = make_float4(g[k] * run.x + own[k].x, g[k] * run.y + own[k].y,
                          g[k] * run.z + own[k].z, g[k] * run.w + own[k].w);
      }
  }
  reinterpret_cast<float4*>(s_final + bh * (size_t)np4 * 4)[e] = run;
}

// ---------------------------------------------------------------------------
// 4. per (b, h, chunk, i-tile): y = exp(cum_i) C_i . S_prev + scores . x
// ---------------------------------------------------------------------------

constexpr int OUT_THREADS = 128;  // 2 x 2 warps of 32 rows x P/2 columns
constexpr int LDS = TQ + LDP_PAD; // the A tile; A fragments walk rows
constexpr int A_PER_THREAD = TQ * TQ / 4 / OUT_THREADS;  // float4s of an A tile

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One pipeline of 64-deep steps, each an A tile (64 x 64, through registers
// into Ps) times a B tile (64 x P, cp.async into a double buffer):
//   steps 0 .. nks-1: A = exp(cum_i) C_i[:, 64 ks ..], B = S_prev[64 ks .., :]
//                     (the inter-chunk term, n in slices of 64);
//   steps nks ..    : A = the scores of j-tile jt, B = x_jt, jt = 0 .. it.
// The next step's A is fetched into registers and its B copied while the
// tensor cores work on the current one.
template <int P>
__global__ void __launch_bounds__(OUT_THREADS, 4)
ssd_chunk_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ C, const float* __restrict__ cb,
                     const float* __restrict__ cum_g, const float* __restrict__ states,
                     float* __restrict__ y, Dims d) {
  constexpr int LDX = P + 8;               // B tiles: B fragments walk columns
  constexpr int NT = P / 16;
  extern __shared__ float4 smem4[];
  float* Ps = reinterpret_cast<float*>(smem4);  // (TQ, LDS)
  float* xs = Ps + TQ * LDS;               // 2 x (TQ, LDX)
  float* cum_i = xs + 2 * TQ * LDX;        // (TQ)
  float* cj = cum_i + TQ;                  // 2 x (TQ)
  float* dj = cj + 2 * TQ;                 // 2 x (TQ)

  const int c = blockIdx.x / d.ntile;
  const int it = d.ntile - 1 - blockIdx.x % d.ntile;   // heaviest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int i0 = it * TQ, qv = valid_rows(d, c);
  if (i0 >= qv) return;                    // the ragged chunk's empty tiles
  const size_t xstride = (size_t)d.h * P;
  const int nks = (d.n + TQ - 1) / TQ, nsteps = nks + it + 1;

  // this thread's share of an A tile: rows arow + 8 q, columns acol..acol+3
  const int arow = tid / (TQ / 4), acol = (tid % (TQ / 4)) * 4;
  float4 ar[A_PER_THREAD];
  auto fetch_a = [&](int step) {
    if (step < nks) {                      // C rows of the i-tile, columns 64 step ..
      const int k = step * TQ + acol;
#pragma unroll
      for (int q = 0; q < A_PER_THREAD; ++q) {
        const int lr = i0 + arow + 8 * q;
        ar[q] = lr < qv && k < d.n
                    ? __ldg(reinterpret_cast<const float4*>(
                          C + ((size_t)bb * d.s + (size_t)c * d.Q + lr) * d.n + k))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {                               // the cb tile (it, jt)
      const float* src = cb + (((size_t)bb * d.nc + c) * d.Qp + i0 + arow) * d.Qp +
                         (step - nks) * TQ + acol;
#pragma unroll
      for (int q = 0; q < A_PER_THREAD; ++q)
        ar[q] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(8 * q) * d.Qp));
    }
  };
  auto copy_b = [&](int step) {
    const int buf = step & 1;
    float* dst = xs + buf * TQ * LDX;
    if (step < nks) {                      // S_prev rows 64 step .., zero past n
      const float* sp = states + bhc * d.n * P;
      for (int idx = tid; idx < TQ * (P / 4); idx += OUT_THREADS) {
        const int r = idx / (P / 4), col = (idx % (P / 4)) * 4, k = step * TQ + r;
        cp_async16(dst + r * LDX + col, k < d.n ? sp + (size_t)k * P + col : sp, k < d.n);
      }
    } else {
      const int j0 = (step - nks) * TQ;
      load_rows<OUT_THREADS>(dst, LDX, x, d, bb, c, j0, TQ, P, P, xstride, (size_t)hh * P);
      if (tid < TQ) {
        const bool ok = j0 + tid < qv;
        cp_async4(cj + buf * TQ + tid, ok ? cum_g + bhc * d.Q + j0 + tid : cum_g, ok);
        cp_async4(dj + buf * TQ + tid,
                  ok ? dt + ((size_t)bb * d.s + (size_t)c * d.Q + j0 + tid) * d.h + hh : dt,
                  ok);
      }
    }
    cp_commit();
  };
  // the A tile of `step` from the registers into Ps: C scaled by exp(cum_i),
  // or the scores cb exp(cum_i - cum_j) dt_j where j <= i < qv, else 0 (a
  // select: above the diagonal the exponent overflows and the diagonal
  // tile's upper half of cb was never written)
  auto store_a = [&](int step) {
    const int buf = step & 1;
    const bool inter = step < nks;
    const int j0 = (step - nks) * TQ;
    const float4 cjv = *reinterpret_cast<const float4*>(cj + buf * TQ + acol);
    const float4 djv = *reinterpret_cast<const float4*>(dj + buf * TQ + acol);
    const float cjs[4] = {cjv.x, cjv.y, cjv.z, cjv.w}, djs[4] = {djv.x, djv.y, djv.z, djv.w};
#pragma unroll
    for (int q = 0; q < A_PER_THREAD; ++q) {
      const int r = arow + 8 * q, gi = i0 + r;
      const float ci = cum_i[r];
      const float v[4] = {ar[q].x, ar[q].y, ar[q].z, ar[q].w};
      float o[4];
      if (inter) {
        const float sc = ex2(ci * kLog2e);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = v[e] * sc;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gj = j0 + acol + e;
          o[e] = (gj <= gi && gi < qv) ? v[e] * ex2((ci - cjs[e]) * kLog2e) * djs[e] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(Ps + r * LDS + acol) = make_float4(o[0], o[1], o[2], o[3]);
    }
  };

  if (tid < TQ) cum_i[tid] = i0 + tid < qv ? cum_g[bhc * d.Q + i0 + tid] : 0.f;
  fetch_a(0);
  copy_b(0);
  cp_wait<0>();
  __syncthreads();
  store_a(0);
  __syncthreads();

  float acc[2][NT][4] = {};
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) {               // the next step's loads fly under the products
      fetch_a(step + 1);
      copy_b(step + 1);
    }
    const float* bt = xs + (step & 1) * TQ * LDX;
    // on the diagonal tile the warp's rows end at wm*32 + 31: the k-steps
    // past them multiply zeros
    const int kend = step == nsteps - 1 ? wm * 32 + 32 : TQ;
#pragma unroll
    for (int k0 = 0; k0 < TQ; k0 += 8) {
      if (k0 >= kend) break;
      uint32_t bbig[NT][2], bsml[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* base = bt + k0 * LDX + wn * (P / 2) + nt * 8;
        load_b(bbig[nt], bsml[nt], g, t, [&](int k, int col) { return base[k * LDX + col]; });
      }
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* base = Ps + (wm * 32 + mt * 16) * LDS + k0;
        load_a(ab[mt], as[mt], g, t, [&](int r, int k) { return base[r * LDS + k]; });
      }
      mma3(acc, ab, as, bbig, bsml);
    }
    if (step + 1 < nsteps) {
      cp_wait<0>();
      __syncthreads();                     // Ps is consumed; the next B tile landed
      store_a(step + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = i0 + wm * 32 + mt * 16 + g + 8 * half;
      if (lr >= qv) continue;
      float* row = y + ((size_t)bb * d.s + (size_t)c * d.Q + lr) * xstride + (size_t)hh * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + wn * (P / 2) + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

size_t cb_smem_bytes(const Dims& d) { return sizeof(float) * 2 * TQ * (d.nk + 4); }

size_t state_smem_bytes(int P, int MQ, const Dims& d) {
  const int qw = (d.Q + TJ - 1) / TJ * TJ;
  return sizeof(float) *
         ((size_t)2 * TJ * (MQ * 64 + 8) + (size_t)2 * TJ * (P + 8) + ST_WARPS + qw);
}

template <int P, int MQ>
cudaError_t launch_state(const float* x, const float* dt, const float* A, const float* B,
                         float* cum, float* decay, float* states, const Dims& d,
                         cudaStream_t stream) {
  const size_t smem = state_smem_bytes(P, MQ, d);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P, MQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_state_kernel<P, MQ><<<dim3(d.nc, d.h, d.b), ST_THREADS, smem, stream>>>(
      x, dt, A, B, cum, decay, states, d);
  return cudaGetLastError();
}

size_t out_smem_bytes(int P) {
  return sizeof(float) * ((size_t)TQ * LDS + (size_t)2 * TQ * (P + 8) + 5 * TQ);
}

template <int P>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, float* y, float* s_final, float* states, float* cum,
                   float* decay, float* cb, const Dims& d, cudaStream_t stream) {
  const size_t smem_cb = cb_smem_bytes(d), smem_out = out_smem_bytes(P);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_cb)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(ssd_chunk_out_kernel<P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_out)) !=
          cudaSuccess)
    return err;

  ssd_cb_kernel<<<dim3(d.ntile * (d.ntile + 1) / 2, d.nc, d.b), CB_THREADS, smem_cb, stream>>>(
      B, C, cb, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  switch ((d.n + 63) / 64) {               // m-tiles a warp of the state kernel
    case 1: err = launch_state<P, 1>(x, dt, A, B, cum, decay, states, d, stream); break;
    case 2: err = launch_state<P, 2>(x, dt, A, B, cum, decay, states, d, stream); break;
    case 3: err = launch_state<P, 3>(x, dt, A, B, cum, decay, states, d, stream); break;
    default: err = launch_state<P, 4>(x, dt, A, B, cum, decay, states, d, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int np4 = d.n * P / 4;
  ssd_state_pass_kernel<<<dim3((np4 + PASS_THREADS - 1) / PASS_THREADS, d.b * d.h),
                          PASS_THREADS, 0, stream>>>(states, decay, s_final, d.nc, np4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_out_kernel<P><<<dim3(d.nc * d.ntile, d.h, d.b), OUT_THREADS, smem_out, stream>>>(
      x, dt, C, cb, cum, states, y, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n): f32, contiguous, 16-byte
// aligned, on the current device. Writes y (b,s,h,p) and s_final (b,h,n,p).
// Scratch from the caller: states (b,h,nc,n,p), cum (b,h,nc,Q), decay
// (b,h,nc) and cb (b,nc,Qp,Qp), with Q = chunk (the caller passes
// min(chunk, s)), nc = ceil(s / Q) and Qp = ceil(Q / 64) * 64. p in
// {16, 32, 64}; n a multiple of 4 up to 256. Launches the four kernels on
// `stream` without synchronising; returns the first launch error
// (cudaGetLastError()), or cudaErrorInvalidValue.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
            void* y, void* s_final, void* states, void* cum, void* decay, void* cb, int b,
            int s, int h, int p, int n, int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 || n <= 0 || n % 4 ||
      n > MAX_N || chunk <= 0 || chunk > MAX_CHUNK || chunk > s)
    return cudaErrorInvalidValue;
  const int nc = (s + chunk - 1) / chunk, ntile = (chunk + TQ - 1) / TQ;
  Dims d{b, s, h, n, (n + 15) / 16 * 16, chunk, nc, ntile, ntile * TQ};
  if ((long long)nc * ntile > 0x7fffffffLL || (long long)b * h > 65535 || nc > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fx = static_cast<const float*>(x), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A), *fB = static_cast<const float*>(B),
              *fC = static_cast<const float*>(C);
  float *fy = static_cast<float*>(y), *fs = static_cast<float*>(s_final),
        *fst = static_cast<float*>(states), *fcum = static_cast<float*>(cum),
        *fdec = static_cast<float*>(decay), *fcb = static_cast<float*>(cb);
  switch (p) {
    case 16: return launch<16>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, fcb, d, st);
    case 32: return launch<32>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, fcb, d, st);
    case 64: return launch<64>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, fcb, d, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
