// Flash attention forward for Hopper (sm_90a): causal / sliding window / GQA,
// bf16 or f32, with a plain C interface (loaded from Python with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention_tpu
// (Pallas, body `_kernel`) and computes the same function:
//   q (BH, Sq, hd), k/v (BKV, Sk, hd), BH = BKV * G; q head bh reads kv head bh / G.
//   mask: kpos < Sk; causal kpos <= qpos (top-left aligned, both from 0);
//         window qpos - kpos < window.
//   Running max / sum / accumulator in f32; p is rounded to v's type before
//   P.V; out = acc / max(l, 1e-37) in q's type. Masked scores are the finite
//   -2e38 of the TPU kernel, and masked probabilities are exactly 0, so a
//   row that has seen no valid key yet carries l = 0, acc = 0 (a row with no
//   valid key at all comes out 0).
//
// What bounds it: at the serving shapes (hd 256, S 2048, GQA 2) a layer does
// ~7e10 FLOP of Q.K^T and P.V against ~100 MB of q/k/v/o, far above the
// H100's ~295 FLOP/byte balance point, so tensor-core operations bound it.
// What the design does about that:
//   * one block of 4 warps per (bh, 64-row q tile); a loop over 64-key kv
//     tiles inside the block replaces the TPU's sequential kv grid axis;
//   * bf16 products run on the tensor cores (mma.sync m16n8k16, f32
//     accumulate); the S fragment is reused in registers as the A operand of
//     P.V, so P never touches shared memory;
//   * kv tiles that are fully masked (above the causal diagonal or wholly
//     outside the window) are skipped: a windowed q tile reads at most
//     window + 64 keys, and the heaviest causal q tiles are launched first;
//   * shared-memory rows are padded by 16 bytes so fragment loads are free
//     of bank conflicts; the ragged Sq/Sk edge is masked here, so the
//     wrapper copies nothing for padding.
// The f32 variant (for tight-tolerance checks) keeps the same tiling and
// fragment ownership but multiplies with scalar FMAs.
// Not yet: wgmma, TMA and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // q rows per block, 16 per warp
constexpr int BN = 64;              // keys per kv tile
constexpr int NWARPS = BM / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -2.0e38f;

typedef __nv_bfloat16 bf16;

template <typename T>
struct Tile {
  static constexpr int PAD = 16 / sizeof(T);   // 16-byte row padding
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T, int HD>
__host__ __device__ constexpr int row_stride() { return HD + Tile<T>::PAD; }

template <typename T, int HD>
constexpr size_t smem_bytes() {
  // q, k, v tiles; the f32 variant also stages P per warp
  return (size_t)(BM + 2 * BN) * row_stride<T, HD>() * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)NWARPS * 16 * BN * sizeof(float) : 0);
}

// Copy `nrows` rows of a (rows, HD) row-major tile into padded shared memory,
// 16 bytes per thread and step; rows at or past `valid` are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  constexpr int LD = row_stride<T, HD>();
  for (int c = threadIdx.x; c < nrows * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// D = A.B + D, A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment ownership (the m16n8k16 accumulator layout, used by both types):
// lane = 4*g + t; in every 16x8 tile the thread holds rows g (e = 0, 1) and
// g + 8 (e = 2, 3), columns 2t + (e & 1).
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int G, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = row_stride<T, HD>();
  constexpr int NT = BN / 8;                      // 8-key column tiles of S
  constexpr int OT = HD / 8;                      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * LD;
  T* Vs = Ks + BN * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // heaviest tiles first
  const int bh = blockIdx.y;
  const T* qb = q + ((size_t)bh * Sq + q0) * HD;
  const T* kb = k + (size_t)(bh / G) * Sk * HD;
  const T* vb = v + (size_t)(bh / G) * Sk * HD;

  load_tile<T, HD>(Qs, qb, Sq - q0, BM);

  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BM);
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
    load_tile<T, HD>(Ks, kb + (size_t)k0 * HD, Sk - k0, BN);
    load_tile<T, HD>(Vs, vb + (size_t)k0 * HD, Sk - k0, BN);
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys ----
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (sizeof(T) == 2) {
      const bf16* qw = reinterpret_cast<const bf16*>(Qs) + warp * 16 * LD;
      const bf16* kt = reinterpret_cast<const bf16*>(Ks);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4];
        a[0] = ld32(qw + g * LD + kk + 2 * t);
        a[1] = ld32(qw + (g + 8) * LD + kk + 2 * t);
        a[2] = ld32(qw + g * LD + kk + 2 * t + 8);
        a[3] = ld32(qw + (g + 8) * LD + kk + 2 * t + 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const bf16* kr = kt + (n * 8 + g) * LD + kk + 2 * t;
          const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
          mma_bf16(s[n], a, b);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* qr = reinterpret_cast<const float*>(Qs) + (warp * 16 + g + (e >> 1) * 8) * LD;
          const float* kr = reinterpret_cast<const float*>(Ks) + (n * 8 + 2 * t + (e & 1)) * LD;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
          s[n][e] = dot;
        }
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
    if constexpr (sizeof(T) == 2) {
      const bf16* vt = reinterpret_cast<const bf16*>(Vs);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // the S accumulator of key tiles 2j, 2j+1 is the A fragment of keys 16j..16j+15
        const uint32_t a[4] = {pack_float2(s[2 * j][0], s[2 * j][1]),
                               pack_float2(s[2 * j][2], s[2 * j][3]),
                               pack_float2(s[2 * j + 1][0], s[2 * j + 1][1]),
                               pack_float2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          const bf16* vr = vt + (j * 16 + 2 * t) * LD + n * 8 + g;
          const uint32_t b[2] = {pack_bf16(vr[0], vr[LD]), pack_bf16(vr[8 * LD], vr[9 * LD])};
          mma_bf16(acc[n], a, b);
        }
      }
    } else {
      float* ps = reinterpret_cast<float*>(Vs + BN * LD) + warp * 16 * BN;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[(g + (e >> 1) * 8) * BN + n * 8 + 2 * t + (e & 1)] = s[n][e];
      __syncwarp();
      const float* vt = reinterpret_cast<const float*>(Vs);
#pragma unroll
      for (int n = 0; n < OT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* pr = ps + (g + (e >> 1) * 8) * BN;
          const float* vc = vt + n * 8 + 2 * t + (e & 1);
          float dot = 0.f;
#pragma unroll 8
          for (int j = 0; j < BN; ++j) dot = fmaf(pr[j], vc[j * LD], dot);
          acc[n][e] += dot;
        }
      __syncwarp();
    }
  }

  // ---- out = acc / max(l, 1e-37) ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = fmaxf(l_run[r], 1e-37f);
  }
  T* ob = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = row0 + (e >> 1) * 8;
      if (qp < Sq) ob[(size_t)qp * HD + n * 8 + 2 * t + (e & 1)] = from_float<T>(acc[n][e] / l_run[e >> 1]);
    }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH,
                   int BKV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, BH);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), BH / BKV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int BH, int BKV, int Sq, int Sk, int causal, int window,
                        float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (BH, Sq, hd), k/v (BKV, Sk, hd), o (BH, Sq, hd), all contiguous and
// 16-byte aligned on the current device. is_bf16: 1 for bf16, 0 for f32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int BH, int BKV, int Sq, int Sk, int hd, int is_bf16,
                        int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_hd<bf16>(hd, q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s)
                 : dispatch_hd<float>(hd, q, k, v, o, BH, BKV, Sq, Sk, causal, window, scale, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
