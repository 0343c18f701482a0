// Mamba2 SSD (state-space duality) forward for Hopper (sm_90a), f32, with a
// plain C interface (loaded from Python with ctypes).
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
// S in VMEM scratch. Blocks on the card run in no order, so one call is
// three kernels on one stream, each with enough blocks to fill 132 SMs:
//   1. ssd_chunk_state_kernel, one block per (b, h, chunk): the chunk's cum
//      (block scan) and its own state sum_j B_j w_j x_j^T from zero, with
//      its decay exp(cum_last);
//   2. ssd_state_pass_kernel, elementwise over (b, h, n*p): walks the chunks
//      in order and turns each chunk's own state into the state entering it
//      (S_prev), and writes S_final;
//   3. ssd_chunk_out_kernel, one block per (b, h, chunk, 64-row i-tile): the
//      intra-chunk term tile by tile (C_i B_j^T over n, then scores . x_j for
//      64-row j-tiles with j <= i) plus the inter-chunk term C_i . S_prev.
//   This is the chunk-parallel form (arXiv:2405.21060, SS6) rather than one
//   block per (b, h) walking its chunks: that would give 192 blocks at the
//   mamba2-780m serving shape (b 4, h 48), 1.5 waves on 132 SMs, with one
//   block's ~100 KB of tiles per SM. Here kernels 1 and 3 launch 1,536 and
//   6,144 blocks. The wrapper counts the three as one launch of the kernel.
//
// What bounds it: at the serving shape (b 4, s 2048, h 48, p 64, n 128,
// chunk 256) the function needs ~2e10 f32 FLOP (the causal half of C B^T
// once per (b, chunk), the causal half of scores . x, C . S_prev and the
// state update per (b, h, chunk)) against ~0.22 GB of inputs and outputs;
// at the H100's f32 rate without tensor cores (67 TFLOP/s) and 3.35 TB/s
// the operations bound it (~0.29 ms against ~0.065 ms).
// What the design does about that:
//   * all products are f32 FMAs out of shared memory with 4x4 register
//     tiles (two 16-byte loads per 16 FMAs); rows are padded by 16 bytes so
//     the loads are free of bank conflicts;
//   * j-tiles above the diagonal are never visited, and the heaviest i-tiles
//     (most j-tiles) are launched first;
//   * the ragged chunk and sequence edges are masked in the kernels, so the
//     wrapper copies nothing for padding;
//   * B and C are read per head from the shared (b,s,n) arrays (L2 keeps
//     them across the 48 heads); C_i B_j^T is recomputed per head and the
//     diagonal tiles are done in full, ~1.9x the operations counted above
//     (1.68 ms against the 0.29 ms bound, NVIDIA H100 80GB HBM3, 700.00 W,
//     PERF.md).
//     Computing it once per (b, chunk), tensor cores (TF32 loses the 2e-3
//     sweep tolerance; 3xTF32 would not), TMA and wgmma are later speed work.
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TQ = 64;           // rows of an i-tile or a j-tile inside a chunk
constexpr int PAD = 4;           // floats of row padding (16 bytes)
constexpr int LDQ = TQ + PAD;    // row stride of the scores tile
constexpr int MAX_CHUNK = 4096;  // the chunk's cum lives in shared memory
constexpr int MAX_N = 256;

struct Dims {
  int b, s, h, n;
  int Q;      // rows per chunk
  int nc;     // chunks
  int ntile;  // i-tiles per chunk, ceil(Q / TQ)
};

__device__ __forceinline__ float4 f4_load(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void f4_store(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float f4_get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Copy rows [r0, r0 + TQ) of chunk c of a (b, s, [h,] width) array into a
// padded (TQ, width + PAD) shared tile, 16 bytes per thread and step. Rows
// past the chunk or the sequence are zero-filled; `stride` is the distance
// in floats between consecutive sequence rows and `off` the offset of the
// wanted head. When `w` is given each row is scaled by w[row].
__device__ __forceinline__ void load_rows(float* dst, const float* src, const Dims& d,
                                          int bb, int c, int r0, int width, size_t stride,
                                          size_t off, const float* w = nullptr) {
  const int cpr = width / 4;
  const int ld = width + PAD;
  for (int idx = threadIdx.x; idx < TQ * cpr; idx += NTHREADS) {
    const int r = idx / cpr, col = (idx % cpr) * 4;
    const int lr = r0 + r;                 // row inside the chunk
    const int t = c * d.Q + lr;            // row of the sequence
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lr < d.Q && t < d.s) {
      v = f4_load(src + ((size_t)bb * d.s + t) * stride + off + col);
      if (w) {
        const float s = w[r];
        v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      }
    }
    f4_store(dst + r * ld + col, v);
  }
}

// ---------------------------------------------------------------------------
// 1. per (b, h, chunk): cum, decay and the chunk's own state
// ---------------------------------------------------------------------------

// Rows of the state each thread owns per slice of n: P/4 threads span the p
// columns (4 each), the other NTHREADS*4/P span rows, RS rows per thread.
constexpr int RS = 8;

template <int P>
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ cum_g, float* __restrict__ decay,
                       float* __restrict__ states, Dims d) {
  constexpr int TX = P / 4, TY = NTHREADS / TX, LDP = P + PAD;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = d.n, LDN = n + PAD;
  float* Bs = smem;                       // (TQ, LDN)
  float* xs = Bs + TQ * LDN;              // (TQ, LDP), rows scaled by w_j
  float* ws = xs + TQ * LDP;              // (TQ) w_j = dt_j exp(cum_last - cum_j)
  float* warp_tot = ws + TQ;              // (NWARPS)
  float* cum = warp_tot + NWARPS;         // (Q)

  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const float Ah = A[hh];

  // inclusive block scan of dt * A over the chunk's rows
  float carry = 0.f;
  for (int base = 0; base < d.Q; base += NTHREADS) {
    const int r = base + tid, t = c * d.Q + r;
    float v = (r < d.Q && t < d.s) ? dt[((size_t)bb * d.s + t) * d.h + hh] * Ah : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < NWARPS ? warp_tot[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < NWARPS; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < NWARPS) warp_tot[lane] = w;
    }
    __syncthreads();
    if (r < d.Q) cum[r] = carry + (warp ? warp_tot[warp - 1] : 0.f) + v;
    carry += warp_tot[NWARPS - 1];
    __syncthreads();
  }
  for (int r = tid; r < d.Q; r += NTHREADS) cum_g[bhc * d.Q + r] = cum[r];
  const float cum_last = cum[d.Q - 1];
  if (tid == 0) decay[bhc] = expf(cum_last);

  const int tx = tid % TX, ty = tid / TX;
  const size_t xstride = (size_t)d.h * P;
  for (int k0 = 0; k0 < n; k0 += TY * RS) {
    float acc[RS][4];
#pragma unroll
    for (int r = 0; r < RS; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    int kk[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) kk[r] = min(k0 + ty + TY * r, n - 1);
    for (int j0 = 0; j0 < d.Q; j0 += TQ) {
      __syncthreads();                      // the previous tiles are consumed
      if (tid < TQ) {
        const int lr = j0 + tid, t = c * d.Q + lr;
        ws[tid] = (lr < d.Q && t < d.s)
                      ? dt[((size_t)bb * d.s + t) * d.h + hh] * expf(cum_last - cum[lr])
                      : 0.f;
      }
      load_rows(Bs, B, d, bb, c, j0, n, (size_t)n, 0);
      __syncthreads();
      load_rows(xs, x, d, bb, c, j0, P, xstride, (size_t)hh * P, ws);
      __syncthreads();
      const int jn = min(TQ, d.Q - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 xv = f4_load(xs + j * LDP + 4 * tx);
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          const float bv = Bs[j * LDN + kk[r]];
          acc[r][0] = fmaf(bv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(bv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(bv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(bv, xv.w, acc[r][3]);
        }
      }
    }
    float* out = states + bhc * n * P;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int k = k0 + ty + TY * r;
      if (k < n) f4_store(out + (size_t)k * P + 4 * tx,
                          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// 2. per (b, h): chunk states -> state entering each chunk, and S_final
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                      float* __restrict__ s_final, int nc, int np4) {
  const int e = blockIdx.x * NTHREADS + threadIdx.x;
  if (e >= np4) return;
  const size_t bh = blockIdx.y;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    float4* ptr = reinterpret_cast<float4*>(states + (bh * nc + c) * (size_t)np4 * 4) + e;
    const float4 st = *ptr;
    *ptr = run;
    const float g = decay[bh * nc + c];
    run = make_float4(g * run.x + st.x, g * run.y + st.y, g * run.z + st.z, g * run.w + st.w);
  }
  reinterpret_cast<float4*>(s_final + bh * (size_t)np4 * 4)[e] = run;
}

// ---------------------------------------------------------------------------
// 3. per (b, h, chunk, i-tile): y = intra + inter
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(NTHREADS, 2)
ssd_chunk_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ B, const float* __restrict__ C,
                     const float* __restrict__ cum_g, const float* __restrict__ states,
                     float* __restrict__ y, Dims d) {
  constexpr int TX = P / 4, TY = NTHREADS / TX, RY = TQ / TY, LDP = P + PAD;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = d.n, LDN = n + PAD;
  const int union_size = max(TQ * LDN, n * LDP);
  float* Cs = smem;                       // (TQ, LDN) rows of C of the i-tile
  float* Bs = Cs + TQ * LDN;              // (TQ, LDN) rows of B of a j-tile; then S_prev (n, LDP)
  float* xs = Bs + union_size;            // (TQ, LDP)
  float* Ps = xs + TQ * LDP;              // (TQ, LDQ) scores of the (i, j) tile pair
  float* cum_i = Ps + TQ * LDQ;           // (TQ)
  float* cum_j = cum_i + TQ;              // (TQ)
  float* dt_j = cum_j + TQ;               // (TQ)

  const int c = blockIdx.x / d.ntile;
  const int it = d.ntile - 1 - blockIdx.x % d.ntile;   // heaviest tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bhc = ((size_t)bb * d.h + hh) * d.nc + c;
  const int i0 = it * TQ;
  const size_t xstride = (size_t)d.h * P;
  auto valid = [&](int lr) { return lr < d.Q && c * d.Q + lr < d.s; };

  load_rows(Cs, C, d, bb, c, i0, n, (size_t)n, 0);
  if (tid < TQ) cum_i[tid] = valid(i0 + tid) ? cum_g[bhc * d.Q + i0 + tid] : 0.f;

  // scores tile: 16 x 16 threads, 4 x 4 each, rows cy + 16 r, columns cx + 16 q
  const int cx = tid % 16, cy = tid / 16;
  // output tile: P/4 threads over the columns (4 each), rows ty + TY r
  const int tx = tid % TX, ty = tid / TX;
  float acc[RY][4];
#pragma unroll
  for (int r = 0; r < RY; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * TQ;
    __syncthreads();                        // the previous tiles are consumed
    load_rows(Bs, B, d, bb, c, j0, n, (size_t)n, 0);
    load_rows(xs, x, d, bb, c, j0, P, xstride, (size_t)hh * P);
    if (tid < TQ) {
      const int lr = j0 + tid, t = c * d.Q + lr;
      const bool ok = valid(lr);
      cum_j[tid] = ok ? cum_g[bhc * d.Q + lr] : 0.f;
      dt_j[tid] = ok ? dt[((size_t)bb * d.s + t) * d.h + hh] : 0.f;
    }
    __syncthreads();

    float cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cb[r][0] = cb[r][1] = cb[r][2] = cb[r][3] = 0.f;
    for (int k = 0; k < n; k += 4) {
      float4 a[4], bq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = f4_load(Cs + (cy + 16 * r) * LDN + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) bq[q] = f4_load(Bs + (cx + 16 * q) * LDN + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = cb[r][q];
          s = fmaf(a[r].x, bq[q].x, s);
          s = fmaf(a[r].y, bq[q].y, s);
          s = fmaf(a[r].z, bq[q].z, s);
          s = fmaf(a[r].w, bq[q].w, s);
          cb[r][q] = s;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = cy + 16 * r, j = cx + 16 * q;
        const bool keep = i0 + i >= j0 + j && valid(i0 + i) && valid(j0 + j);
        Ps[i * LDQ + j] = keep ? cb[r][q] * expf(cum_i[i] - cum_j[j]) * dt_j[j] : 0.f;
      }
    __syncthreads();

    for (int j = 0; j < TQ; j += 4) {
      float4 pa[RY];
#pragma unroll
      for (int r = 0; r < RY; ++r) pa[r] = f4_load(Ps + (ty + TY * r) * LDQ + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = f4_load(xs + (j + q) * LDP + 4 * tx);
#pragma unroll
        for (int r = 0; r < RY; ++r) {
          const float pv = f4_get(pa[r], q);
          acc[r][0] = fmaf(pv, xv.x, acc[r][0]);
          acc[r][1] = fmaf(pv, xv.y, acc[r][1]);
          acc[r][2] = fmaf(pv, xv.z, acc[r][2]);
          acc[r][3] = fmaf(pv, xv.w, acc[r][3]);
        }
      }
    }
  }

  // inter-chunk term: (C_i . S_prev) * exp(cum_i), S_prev into the B buffer
  __syncthreads();
  float* Ss = Bs;                           // (n, LDP)
  const float* sp = states + bhc * n * P;
  for (int idx = tid; idx < n * TX; idx += NTHREADS) {
    const int k = idx / TX, col = (idx % TX) * 4;
    f4_store(Ss + k * LDP + col, f4_load(sp + (size_t)k * P + col));
  }
  __syncthreads();
  float inter[RY][4];
#pragma unroll
  for (int r = 0; r < RY; ++r) inter[r][0] = inter[r][1] = inter[r][2] = inter[r][3] = 0.f;
  for (int k = 0; k < n; k += 4) {
    float4 ca[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) ca[r] = f4_load(Cs + (ty + TY * r) * LDN + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 sv = f4_load(Ss + (k + q) * LDP + 4 * tx);
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const float cv = f4_get(ca[r], q);
        inter[r][0] = fmaf(cv, sv.x, inter[r][0]);
        inter[r][1] = fmaf(cv, sv.y, inter[r][1]);
        inter[r][2] = fmaf(cv, sv.z, inter[r][2]);
        inter[r][3] = fmaf(cv, sv.w, inter[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int i = ty + TY * r, lr = i0 + i;
    if (!valid(lr)) continue;
    const float g = expf(cum_i[i]);
    const size_t t = (size_t)c * d.Q + lr;
    f4_store(y + ((size_t)bb * d.s + t) * xstride + (size_t)hh * P + 4 * tx,
             make_float4(acc[r][0] + inter[r][0] * g, acc[r][1] + inter[r][1] * g,
                         acc[r][2] + inter[r][2] * g, acc[r][3] + inter[r][3] * g));
  }
}

size_t state_smem_bytes(int P, int n, int Q) {
  return sizeof(float) * ((size_t)TQ * (n + PAD) + (size_t)TQ * (P + PAD) + TQ + NWARPS + Q);
}

size_t out_smem_bytes(int P, int n) {
  const size_t u = (size_t)TQ * (n + PAD) > (size_t)n * (P + PAD) ? (size_t)TQ * (n + PAD)
                                                                    : (size_t)n * (P + PAD);
  return sizeof(float) * ((size_t)TQ * (n + PAD) + u + (size_t)TQ * (P + PAD) +
                          (size_t)TQ * LDQ + 3 * TQ);
}

template <int P>
cudaError_t launch(const float* x, const float* dt, const float* A, const float* B,
                   const float* C, float* y, float* s_final, float* states, float* cum,
                   float* decay, const Dims& d, cudaStream_t stream) {
  const size_t smem1 = state_smem_bytes(P, d.n, d.Q), smem3 = out_smem_bytes(P, d.n);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;

  ssd_chunk_state_kernel<P><<<dim3(d.nc, d.h, d.b), NTHREADS, smem1, stream>>>(
      x, dt, A, B, cum, decay, states, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int np4 = d.n * P / 4;
  ssd_state_pass_kernel<<<dim3((np4 + NTHREADS - 1) / NTHREADS, d.b * d.h), NTHREADS, 0,
                          stream>>>(states, decay, s_final, d.nc, np4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_out_kernel<P><<<dim3(d.nc * d.ntile, d.h, d.b), NTHREADS, smem3, stream>>>(
      x, dt, B, C, cum, states, y, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n): f32, contiguous, 16-byte
// aligned, on the current device. Writes y (b,s,h,p) and s_final (b,h,n,p).
// Scratch from the caller: states (b,h,nc,n,p), cum (b,h,nc,Q), decay
// (b,h,nc), with Q = chunk (the caller passes min(chunk, s)) and
// nc = ceil(s / Q). p in {16, 32, 64}; n a multiple of 4 up to 256.
// Launches the three kernels on `stream` without synchronising; returns
// the first launch error (cudaGetLastError()), or cudaErrorInvalidValue.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
            void* y, void* s_final, void* states, void* cum, void* decay, int b, int s,
            int h, int p, int n, int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 || n <= 0 || n % 4 ||
      n > MAX_N || chunk <= 0 || chunk > MAX_CHUNK || chunk > s)
    return cudaErrorInvalidValue;
  Dims d{b, s, h, n, chunk, (s + chunk - 1) / chunk, (chunk + TQ - 1) / TQ};
  if ((long long)d.nc * d.ntile > 0x7fffffffLL || (long long)b * h > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fx = static_cast<const float*>(x), *fdt = static_cast<const float*>(dt),
              *fA = static_cast<const float*>(A), *fB = static_cast<const float*>(B),
              *fC = static_cast<const float*>(C);
  float *fy = static_cast<float*>(y), *fs = static_cast<float*>(s_final),
        *fst = static_cast<float*>(states), *fcum = static_cast<float*>(cum),
        *fdec = static_cast<float*>(decay);
  switch (p) {
    case 16: return launch<16>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, d, st);
    case 32: return launch<32>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, d, st);
    case 64: return launch<64>(fx, fdt, fA, fB, fC, fy, fs, fst, fcum, fdec, d, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
