// Flash attention backward for Hopper (sm_90a): causal / sliding window /
// GQA, bf16 or f32, with a plain C interface (loaded from Python with ctypes).
//
// The gradient of the function that flash_attention.cu computes, which
// replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_tpu.
// The JAX package differentiates that function through XLA (it defines no
// custom_vjp); this is the port's kernel for the same gradient, the
// FlashAttention-2 backward with the forward's masks:
//   q (BH, Sq, hd), k/v (BKV, Sk, hd), BH = BKV * G; o, dO (BH, Sq, hd);
//   lse (BH, Sq) f32, the forward's row logsumexp of the scaled scores.
//   mask: kpos < Sk; causal kpos <= qpos (top-left aligned); window
//         qpos - kpos < window.
//   D = rowsum(dO o) (f32); per (q row, key) pair the mask keeps:
//   S = scale q.k, P = exp(S - lse), dV += P dO (P rounded to v's type, as
//   the forward rounds it before P.V), dP = dO.v, dS = P (dP - D) (rounded
//   to the input type before its products), dK += scale dS q, dQ += scale dS k.
//   Sums in f32; dQ, dK and dV come out in the inputs' type. dK and dV of kv
//   head j sum over its G query heads.
//
// Three kernels on one stream, no atomics, so every call gives the same bits:
//   flash_bwd_delta_kernel  D, one warp a row;
//   flash_bwd_dkdv_kernel   a block owns BN keys of one kv head and loops
//                           over the G query heads of the group and, for
//                           each, over the 64-row q tiles that see its keys
//                           (fully masked tiles are skipped: a windowed kv
//                           tile meets at most window + BN + 63 rows);
//                           dK and dV stay in registers;
//   flash_bwd_dq_kernel     a block owns 64 q rows of one head and loops
//                           over the kv tiles they see; dQ stays in registers.
// Each recomputes S and dP (7 products a pair where the gradient needs 5).
//
// What bounds it: 10 hd FLOP a kept pair (the 5 products) against q, k, v,
// o, dO, dQ, dK, dV moved once: at the training shapes (hd 256, S 2048) the
// bf16 tensor cores. This is the first, simple design: 8 warps a block,
// tiles loaded synchronously into padded shared memory, bf16 products by
// mma.sync m16n8k16 (fragments built from 32-bit shared loads, or from two
// 16-bit loads where the operand is k-major), f32 products by scalar FMAs.
// Not yet: wgmma, TMA and a pipeline of loads; one kernel for dQ as well.
// At hd 256 a 64-key tile's f32 dK and dV would take 128 KB of registers,
// so the hd-256 kv tile is 32 keys (64 accumulators a thread).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 64;                       // q rows per tile (both kernels)

template <int HD>
struct Tiles {
  static constexpr int BN = HD >= 256 ? 32 : 64;   // keys per kv tile
};

// row padding: 16 bytes, so that fragment loads hit distinct banks
template <typename T>
__host__ __device__ constexpr int pad() { return 16 / (int)sizeof(T); }

// A ROWS x COLS output split into 16 x 8 mma tiles, NT consecutive tiles of
// one 16-row group per warp (so that a warp's A fragments serve NT products)
template <int ROWS, int COLS>
struct Split {
  static constexpr int NT = (ROWS / 16) * (COLS / 8) / WARPS;
  static_assert(NT >= 1 && (ROWS / 16) * (COLS / 8) % WARPS == 0 && (COLS / 8) % NT == 0,
                "tile split");
  __device__ static void origin(int warp, int& m0, int& n0) {
    const int first = warp * NT;
    m0 = first / (COLS / 8) * 16;
    n0 = first % (COLS / 8) * 8;
  }
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack2(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j][e] += sum_{k < K} A(m0 + g + 8 (e >> 1), k) B(k, n0 + 8 j + 2 t + (e & 1))
// for j < NT: the m16n8 accumulator layout (lane = 4 g + t). A(m, k) =
// As[m * lda + k]; B(k, n) = Bs[n * ldb + k] when B_NK, else Bs[k * ldb + n].
template <typename T, int NT, int K, bool B_NK>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const T* As, int lda, const T* Bs,
                                        int ldb, int m0, int n0, int g, int t) {
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      const bf16* a_lo = As + (m0 + g) * lda + k0 + 2 * t;
      const bf16* a_hi = a_lo + 8 * lda;
      const uint32_t a[4] = {ld32(a_lo), ld32(a_hi), ld32(a_lo + 8), ld32(a_hi + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + g;
        uint32_t b0, b1;
        if constexpr (B_NK) {
          const bf16* bp = Bs + n * ldb + k0 + 2 * t;
          b0 = ld32(bp);
          b1 = ld32(bp + 8);
        } else {
          const bf16* bp = Bs + (k0 + 2 * t) * ldb + n;
          b0 = pack2(bp, bp + ldb);
          b1 = pack2(bp + 8 * ldb, bp + 9 * ldb);
        }
        mma_bf16(acc[j], a, b0, b1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* ar = As + (m0 + g + 8 * (e >> 1)) * lda;
        const int n = n0 + 8 * j + 2 * t + (e & 1);
        float s = acc[j][e];
#pragma unroll 8
        for (int k = 0; k < K; ++k) s = fmaf(ar[k], B_NK ? Bs[n * ldb + k] : Bs[k * ldb + n], s);
        acc[j][e] = s;
      }
  }
}

template <typename T>
__device__ __forceinline__ float to_f(T x) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(x);
  else
    return x;
}

// store the pair (x, y) at p, p + 1 in T
template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
}

// rows [r0, r0 + nrows) of a (rows, HD) row-major array into shared memory
// with row stride ld; rows at or past `valid` are zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int r0, int valid, int nrows) {
  constexpr int PER = 16 / (int)sizeof(T);           // elements of a 16-byte chunk
  constexpr int CPR = HD / PER;
  for (int c = threadIdx.x; c < nrows * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * PER;
    int4 val = make_int4(0, 0, 0, 0);
    if (r0 + r < valid) val = *reinterpret_cast<const int4*>(src + (size_t)(r0 + r) * HD + col);
    *reinterpret_cast<int4*>(dst + r * ld + col) = val;
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// D = rowsum(dO o), one warp a row
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                       long long rows) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32) s = fmaf(to_f(o[row * HD + d]), to_f(dout[row * HD + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// dK, dV: a block per (kv head, BN keys)
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct DkdvSmem {
  static constexpr int BN = Tiles<HD>::BN;
  static constexpr int LD = HD + pad<T>();           // rows of K, V, Q, dO
  static constexpr int LDP = BM + pad<T>();          // rows of P^T, dS^T
  static constexpr size_t BYTES =
      ((size_t)(2 * BN + 2 * BM) * LD + 2 * (size_t)BN * LDP) * sizeof(T) + 2 * BM * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int BKV, int G, int Sq, int Sk, int causal, int window, float scale) {
  using L = DkdvSmem<T, HD>;
  constexpr int BN = L::BN, LD = L::LD, LDP = L::LDP;
  using SA = Split<BN, BM>;                            // S^T, dP^T: BN x BM
  using SB = Split<BN, HD>;                            // dK, dV: BN x HD
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BN * LD;
  T* Qs = Vs + BN * LD;
  T* dOs = Qs + BM * LD;
  T* Ps = dOs + BM * LD;                               // P^T  [key][q row]
  T* dSs = Ps + BN * LDP;                              // dS^T [key][q row]
  float* lse_s = reinterpret_cast<float*>(dSs + BN * LDP);
  float* d_s = lse_s + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x % BKV;
  const int kv0 = (blockIdx.x / BKV) * BN;             // heaviest (earliest) tiles first
  const T* kb = k + (size_t)kvh * Sk * HD;
  const T* vb = v + (size_t)kvh * Sk * HD;
  load_rows<T, HD>(Ks, LD, kb, kv0, Sk, BN);
  load_rows<T, HD>(Vs, LD, vb, kv0, Sk, BN);

  // q rows that see keys [kv0, min(kv0 + BN, Sk))
  const int k_last = min(kv0 + BN, Sk) - 1;
  const int q_lo = causal ? kv0 : 0;
  const int q_hi = window > 0 ? (int)min((long long)Sq, (long long)k_last + window) : Sq;

  int am0, an0, bm0, bn0;
  SA::origin(warp, am0, an0);
  SB::origin(warp, bm0, bn0);
  float acc_dk[SB::NT][4], acc_dv[SB::NT][4];
#pragma unroll
  for (int j = 0; j < SB::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const size_t bh = (size_t)kvh * G + gi;
    const T* qb = q + bh * Sq * HD;
    const T* db = dout + bh * Sq * HD;
    for (int q0 = (q_lo / BM) * BM; q0 < q_hi; q0 += BM) {
      __syncthreads();                                 // the previous tile is fully read
      load_rows<T, HD>(Qs, LD, qb, q0, Sq, BM);
      load_rows<T, HD>(dOs, LD, db, q0, Sq, BM);
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
        d_s[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, this warp's 16 keys x 8 NT q rows
      float s[SA::NT][4], dp[SA::NT][4];
#pragma unroll
      for (int j = 0; j < SA::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      warp_mm<T, SA::NT, HD, true>(s, Ks, LD, Qs, LD, am0, an0, g, t);
      warp_mm<T, SA::NT, HD, true>(dp, Vs, LD, dOs, LD, am0, an0, g, t);
#pragma unroll
      for (int j = 0; j < SA::NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {                  // rows g (h 0) and g + 8 (h 1)
          const int kr = am0 + g + 8 * h;
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = an0 + 8 * j + 2 * t + c;
            const bool ok = keep(q0 + qc, kv0 + kr, Sq, Sk, causal, window);
            p[c] = ok ? expf(s[j][2 * h + c] * scale - lse_s[qc]) : 0.f;
            ds[c] = p[c] * (dp[j][2 * h + c] - d_s[qc]);
          }
          store2<T>(Ps + kr * LDP + an0 + 8 * j + 2 * t, p[0], p[1]);
          store2<T>(dSs + kr * LDP + an0 + 8 * j + 2 * t, ds[0], ds[1]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (scale at the end)
      warp_mm<T, SB::NT, BM, false>(acc_dv, Ps, LDP, dOs, LD, bm0, bn0, g, t);
      warp_mm<T, SB::NT, BM, false>(acc_dk, dSs, LDP, Qs, LD, bm0, bn0, g, t);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kv0 + bm0 + g + 8 * h;
    if (key >= Sk) continue;
    T* dkr = dk + ((size_t)kvh * Sk + key) * HD;
    T* dvr = dv + ((size_t)kvh * Sk + key) * HD;
#pragma unroll
    for (int j = 0; j < SB::NT; ++j) {
      const int col = bn0 + 8 * j + 2 * t;
      store2<T>(dkr + col, acc_dk[j][2 * h] * scale, acc_dk[j][2 * h + 1] * scale);
      store2<T>(dvr + col, acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block per (head, 64 q rows)
// ---------------------------------------------------------------------------

template <typename T, int HD>
struct DqSmem {
  static constexpr int BN = Tiles<HD>::BN;
  static constexpr int LD = HD + pad<T>();
  static constexpr int LDS = BN + pad<T>();          // rows of dS
  static constexpr size_t BYTES =
      ((size_t)(2 * BM + 2 * BN) * LD + (size_t)BM * LDS) * sizeof(T) + 2 * BM * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int BH, int G, int Sq,
                    int Sk, int causal, int window, float scale) {
  using L = DqSmem<T, HD>;
  constexpr int BN = L::BN, LD = L::LD, LDS = L::LDS;
  using SA = Split<BM, BN>;                            // S, dP: BM x BN
  using SB = Split<BM, HD>;                            // dQ: BM x HD
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BM * LD;
  T* Ks = dOs + BM * LD;
  T* Vs = Ks + BN * LD;
  T* dSs = Vs + BN * LD;                               // dS [q row][key]
  float* lse_s = reinterpret_cast<float*>(dSs + BM * LDS);
  float* d_s = lse_s + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Sq + BM - 1) / BM;
  const size_t bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BM;   // heaviest (latest) tiles first
  const T* kb = k + (bh / G) * Sk * HD;
  const T* vb = v + (bh / G) * Sk * HD;
  load_rows<T, HD>(Qs, LD, q + bh * Sq * HD, q0, Sq, BM);
  load_rows<T, HD>(dOs, LD, dout + bh * Sq * HD, q0, Sq, BM);
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
    d_s[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
  }

  // keys that rows [q0, min(q0 + BM, Sq)) see
  const int q_last = min(q0 + BM, Sq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;

  int am0, an0, bm0, bn0;
  SA::origin(warp, am0, an0);
  SB::origin(warp, bm0, bn0);
  float acc[SB::NT][4];
#pragma unroll
  for (int j = 0; j < SB::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kv0 = (k_lo / BN) * BN; kv0 < k_hi; kv0 += BN) {
    __syncthreads();                                   // the previous tile is fully read
    load_rows<T, HD>(Ks, LD, kb, kv0, Sk, BN);
    load_rows<T, HD>(Vs, LD, vb, kv0, Sk, BN);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, this warp's 16 q rows x 8 NT keys
    float s[SA::NT][4], dp[SA::NT][4];
#pragma unroll
    for (int j = 0; j < SA::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mm<T, SA::NT, HD, true>(s, Qs, LD, Ks, LD, am0, an0, g, t);
    warp_mm<T, SA::NT, HD, true>(dp, dOs, LD, Vs, LD, am0, an0, g, t);
#pragma unroll
    for (int j = 0; j < SA::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = am0 + g + 8 * h;
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kc = an0 + 8 * j + 2 * t + c;
          const bool ok = keep(q0 + qr, kv0 + kc, Sq, Sk, causal, window);
          const float p = ok ? expf(s[j][2 * h + c] * scale - lse_s[qr]) : 0.f;
          ds[c] = p * (dp[j][2 * h + c] - d_s[qr]);
        }
        store2<T>(dSs + qr * LDS + an0 + 8 * j + 2 * t, ds[0], ds[1]);
      }
    __syncthreads();

    // dQ += dS K (scale at the end)
    warp_mm<T, SB::NT, BN, false>(acc, dSs, LDS, Ks, LD, bm0, bn0, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + bm0 + g + 8 * h;
    if (row >= Sq) continue;
    T* dqr = dq + (bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < SB::NT; ++j)
      store2<T>(dqr + bn0 + 8 * j + 2 * t, acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
                   const void* dout, void* dq, void* dk, void* dv, float* delta, int BH, int BKV,
                   int Sq, int Sk, int causal, int window, float scale, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  const long long rows = (long long)BH * Sq;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0, stream>>>(
      ot, dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int BN = Tiles<HD>::BN;
  const size_t smem_kv = DkdvSmem<T, HD>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  const long long kv_blocks = (long long)BKV * ((Sk + BN - 1) / BN);
  flash_bwd_dkdv_kernel<T, HD><<<(unsigned)kv_blocks, THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), BKV, BH / BKV, Sq,
      Sk, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = DqSmem<T, HD>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return err;
  const long long q_blocks = (long long)BH * ((Sq + BM - 1) / BM);
  flash_bwd_dq_kernel<T, HD><<<(unsigned)q_blocks, THREADS, smem_q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), BH, BH / BKV, Sq, Sk, causal, window,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k, const void* v, const void* o,
                      const float* lse, const void* dout, void* dq, void* dk, void* dv,
                      float* delta, int BH, int BKV, int Sq, int Sk, int causal, int window,
                      float scale, cudaStream_t s) {
  return is_bf16 ? launch<bf16, HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                                    causal, window, scale, s)
                 : launch<float, HD>(q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                                     causal, window, scale, s);
}

}  // namespace

extern "C" {

// q, o, dout, dq (BH, Sq, hd); k, v, dk, dv (BKV, Sk, hd): contiguous,
// 16-byte aligned, all bf16 (is_bf16 1) or all f32 (0), on the current
// device. lse (BH, Sq) f32 from the forward; delta (BH, Sq) f32 scratch.
// Launches three kernels on `stream` without synchronising; returns the
// first launch error (cudaGetLastError()).
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dout, void* dq, void* dk, void* dv,
                        float* delta, int BH, int BKV, int Sq, int Sk, int hd, int is_bf16,
                        int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 32:
      return launch_hd<32>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 64:
      return launch_hd<64>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 128:
      return launch_hd<128>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                            causal, window, scale, s);
    case 256:
      return launch_hd<256>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, delta, BH, BKV, Sq, Sk,
                            causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
