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
// What bounds it: 10 hd FLOP a kept pair (the 5 products) against q, k, v,
// o, dO, dQ, dK, dV moved once: at the training shapes (hd 256, S 2048) the
// bf16 tensor cores, which only wgmma drives at their rate.
//
// bf16 (the trained path), kernels on one stream, no float atomics, so every
// call gives the same bits:
//   flash_bwd_delta_kernel      D, one warp a row in 16-byte loads (bytes-bound
//                               and small);
//   flash_bwd_dkdv_bf16_kernel  a block owns 64 keys of one kv head and a
//       share of its G query heads; K and V stay in shared memory. A producer
//       warp brings each (head, 64-row q tile) in by TMA, Q and dO into a
//       2-stage ring of full / empty mbarriers, with the tile's lse (times
//       log2 e) and D beside them; 3-D tensor maps over (heads, S, hd)
//       zero-fill rows past S. Two consumer warpgroups (232 registers by
//       setmaxnreg; the producer keeps 40) split the products by kind, so
//       that each keeps one 64 x hd f32 accumulator (128 registers at hd
//       256) and 64 keys fit where a split by rows would hold both:
//         warpgroup 0: S^T = K Q^T (wgmma m64n64k16, both K-major), P^T =
//           exp2(S^T scale log2 e - lse log2 e) masked, handed to warpgroup 1
//           in f32 through shared memory, then dV += P^T dO with P^T as the
//           register A operand (bf16) and dO read MN-major (transpose flag);
//         warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - D), then
//           dK += dS^T Q the same way.
//       The two warpgroups' accumulators have the same layout, so thread i
//       of one reads thread i's P^T of the other (conflict-free, 16 KB);
//       named barriers order the hand-off.
//   GQA split: the G query heads of a kv head go to `splits` blocks
//       (head_splits, below, mirrored by kernels/flash_attention.py), so
//       that the grid fills the card where kv heads are few (recurrentgemma:
//       16 heads over one kv head, 64 blocks unsplit). A split block writes
//       f32 partial dK and dV into scratch and flash_bwd_reduce_kernel sums
//       them in split order. With one split the block writes bf16 directly.
//   flash_bwd_dq_bf16_kernel    a block owns 128 q rows of one head, 64 per
//       consumer warpgroup with Q and dO resident; a producer thread streams
//       64-key K and V tiles through rings of 2 stages (V of 1 at hd 256, to
//       fit shared memory: V is released once dP is in, so its next load
//       overlaps the rest of the tile). Per tile S = Q K^T and dP = dO V^T (wgmma from shared
//       memory), dS in registers, dQ += dS K (dS as the A operand, K read
//       MN-major). A separate dQ kernel recomputes S and dP: 7 products a
//       pair where the gradient needs 5, capping the pair at 5/7 of the
//       bound; folding dQ into the dK/dV kernel deterministically needs a
//       per-q-tile ordering of the kv blocks' adds (FlashAttention-3's
//       deterministic mode), left for later.
// Each consumer waits for each of its products before the next step. Issuing
// the next tile's scores beside the current product (the forward's order)
// measured 25% slower at the training shapes: the dK/dV kernel reads its Q
// and dO tiles again for every 64 keys (about 3.7 TB/s out of L2 at gemma3-4b
// global, its tiles' bytes over its device time) and runs at about half the
// tensor cores' rate, and more work in flight only adds contention (PERF.md,
// K1's backward findings).
// Not yet: fewer L2 reads of Q and dO per key (a 2-block cluster sharing
// them by TMA multicast), TMA stores of the outputs, a dQ pass that does
// not recompute S and dP.
//
// f32 (the 1e-4 reference checks, on no trained path): the first design,
// three kernels with scalar FMAs in the m16n8 accumulator layout, 8 warps a
// block, tiles loaded synchronously into padded shared memory; the dK/dV
// block loops over the G heads. TF32 products would break the tolerance.
#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float to_f(T x) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(x);
  else
    return x;
}

__device__ __forceinline__ bool keep(int qp, int kp, int Sq, int Sk, int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// D = rowsum(dO o), one warp a row (both types)
// ---------------------------------------------------------------------------

constexpr int D_WARPS = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(D_WARPS * 32)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                       long long rows) {
  constexpr int PER = 16 / (int)sizeof(T);           // elements of a 16-byte load
  const long long row = (long long)blockIdx.x * D_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane * PER; c < HD; c += 32 * PER) {
    const int4 x = *reinterpret_cast<const int4*>(o + row * HD + c);
    const int4 y = *reinterpret_cast<const int4*>(dout + row * HD + c);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int j = 0; j < PER; ++j) s = fmaf(to_f(xs[j]), to_f(ys[j]), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, producer warp, two wgmma consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int BWD_BN = 64;       // keys per dK/dV block
constexpr int BWD_BM = 64;       // q rows per dK/dV tile and per dQ consumer warpgroup
constexpr int STAGES = 2;        // ring depth
constexpr int BF16_THREADS = 3 * 128;   // two consumer warpgroups and a producer
constexpr int MIN_BLOCKS = 256;  // the G split aims at two waves of 132 SMs
constexpr int P_FULL = 1, P_EMPTY = 2;  // named barriers of the P^T hand-off

// The G split: the fewest blocks per kv tile, a divisor of G, that give the
// dK/dV grid MIN_BLOCKS blocks (all G when none does).
// kernels/flash_attention.py::bwd_head_splits is the same rule.
int head_splits(int BKV, int G, int Sk) {
  const long long tiles = (long long)BKV * ((Sk + BWD_BN - 1) / BWD_BN);
  for (int s = 1; s < G; ++s)
    if (G % s == 0 && tiles * s >= MIN_BLOCKS) return s;
  return G;
}

// floats of D at the head of the scratch (rounded to 256 bytes), then the
// split partials; kernels/flash_attention.py::bwd_scratch_floats mirrors it
long long delta_floats(int BH, int Sq) { return ((long long)BH * Sq + 63) / 64 * 64; }

// Set a kernel's dynamic shared-memory limit once per device (the call is
// host work; the attention wrappers launch on every layer).
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, int bytes, unsigned long long& done) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && (done >> device) & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d = A B^T (64 x 64) as one wgmma group, both operands K-major in
// shared memory: tiles of 64 rows and HD columns.
template <int HD>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
  using W = Swizzle<HD>;
  // descriptors of k-step 0; k-step kk adds its byte offset / 16 (the empty
  // asm keeps the compiler from holding every k-step's descriptor live)
  uint64_t a_desc = smem_desc(a_tile, 16, 8 * W::SW, W::MODE);
  asm volatile("" : "+l"(a_desc));
  const uint64_t b_desc = smem_desc(b_tile, 16, 8 * W::SW, W::MODE);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = ((kk / (W::BC / 16)) * 64 * W::SW + (kk % (W::BC / 16)) * 32) >> 4;
    if (kk == 0)
      wgmma_ss_n64<false>(d, a_desc, b_desc);
    else
      wgmma_ss_n64<true>(d, a_desc + off, b_desc + off);
  }
  wgmma_commit();
}

// acc (64 x HD) += A B as one wgmma group: A (bf16, K rows deep) from
// registers, B a tile of K rows x HD read MN-major (the transpose flag).
template <int HD, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[HD / 2], const uint32_t (&a)[K / 16][4],
                                         uint32_t b_tile) {
  using W = Swizzle<HD>;
  const uint64_t b_desc = smem_desc(b_tile, K * W::SW, 8 * W::SW, W::MODE);
#pragma unroll
  for (int j = 0; j < K / 16; ++j) wgmma_rs<HD>(acc, a[j], b_desc + ((j * 16 * W::SW) >> 4));
  wgmma_commit();
}

// An m64nN f32 accumulator as bf16 A fragments of K = N: columns 2j and
// 2j + 1 of 8 are the m16n8k16 A fragment of k-step j.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      a[n / 2][(n % 2) * 2 + (e >> 1)] = pack_bf16x2(x[4 * n + e], x[4 * n + e + 1]);
}

// Store a 64 x HD accumulator's rows [0, valid) at out (row stride HD),
// times `mul`: bf16, or f32 partials
template <int HD, typename T>
__device__ __forceinline__ void store_acc(T* out, const float (&acc)[HD / 2], int row0, int valid,
                                          int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= valid) continue;
    T* p = out + (size_t)r * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float x = acc[4 * n + 2 * h] * mul, y = acc[4 * n + 2 * h + 1] * mul;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * n) = __floats2bfloat162_rn(x, y);
      else
        *reinterpret_cast<float2*>(p + 8 * n) = make_float2(x, y);
    }
  }
}

// ---- dK, dV ----

// Shared memory of a dK/dV block: 64-row tiles of NB boxes (Swizzle<HD>)
template <int HD>
struct DkdvSmem {
  using W = Swizzle<HD>;
  static constexpr int BOX = 64 * W::SW;
  static constexpr int TILE = W::NB * BOX;                   // 64 x HD bf16
  static constexpr int K = 0, V = TILE;
  static constexpr int Q = 2 * TILE;                         // stage s: Q at Q + 2 s TILE, dO + TILE
  static constexpr int P = Q + STAGES * 2 * TILE;            // P^T, f32 [32][128 threads]
  static constexpr int STATS = P + 32 * 128 * 4;             // stage s: lse log2 e [64], D [64]
  static constexpr int BAR = STATS + STAGES * 2 * BWD_BM * 4;
  // barriers: fullKV; full, empty [STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;   // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bwd_dkdv_bf16_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                           int BKV, int G, int splits, int Sq, int Sk, int causal, int window,
                           float scale) {
  using L = DkdvSmem<HD>;
  using W = Swizzle<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms need 1024 B
  unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t fullKV = base + L::BAR, full = fullKV + 8, empty = full + 8 * STAGES;

  // block: kv tile (heaviest, i.e. earliest, first), then kv head, then split
  const int per_tile = BKV * splits;
  const int kv0 = (int)(blockIdx.x / per_tile) * BWD_BN;
  const int kvh = (int)(blockIdx.x % per_tile) % BKV, split = (int)(blockIdx.x % per_tile) / BKV;
  const int Gh = G / splits, g0 = split * Gh;
  // the 64-row q tiles that see keys [kv0, min(kv0 + 64, Sk)), for each head
  const int k_last = min(kv0 + BWD_BN, Sk) - 1;
  const int q_lo = causal ? kv0 : 0;
  const int q_hi = window > 0 ? (int)min((long long)Sq, (long long)k_last + window) : Sq;
  const int qt0 = q_lo / BWD_BM;
  const int nqt = q_hi > qt0 * BWD_BM ? (q_hi - qt0 * BWD_BM + BWD_BM - 1) / BWD_BM : 0;
  const int ntiles = Gh * nqt;   // tile i: head g0 + i / nqt, rows (qt0 + i % nqt) * 64

  if (threadIdx.x == 0) {
    mbar_init(fullKV, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);                   // every producer lane
      mbar_init(empty + 8 * s, 8);                   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform for the compiler (see flash_attention.cu)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer: warp 0 keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 2 * 128 + 32 && ntiles > 0) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(fullKV, 2 * L::TILE);
#pragma unroll
        for (int b = 0; b < W::NB; ++b) {
          tma_load_3d(base + L::K + b * L::BOX, &tk, fullKV, b * W::BC, kv0, kvh);
          tma_load_3d(base + L::V + b * L::BOX, &tv, fullKV, b * W::BC, kv0, kvh);
        }
      }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const int bh = kvh * G + g0 + i / nqt, q0 = (qt0 + i % nqt) * BWD_BM;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* st = reinterpret_cast<float*>(sbase + L::STATS) + s * 2 * BWD_BM;
        for (int r = lane; r < BWD_BM; r += 32) {
          const bool in = q0 + r < Sq;
          st[r] = in ? lse[(size_t)bh * Sq + q0 + r] * LOG2E : 0.f;
          st[BWD_BM + r] = in ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * L::TILE);
          const uint32_t qs = base + L::Q + s * 2 * L::TILE;
#pragma unroll
          for (int b = 0; b < W::NB; ++b) {
            tma_load_3d(qs + b * L::BOX, &tq, full + 8 * s, b * W::BC, q0, bh);
            tma_load_3d(qs + L::TILE + b * L::BOX, &tdo, full + 8 * s, b * W::BC, q0, bh);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 0 S^T, P^T, dV; warpgroup 1 dP^T, dS^T, dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int key0 = warp * 16 + g;                  // keys key0 (e = 0, 1), key0 + 8 (e = 2, 3)
    float* const pt = reinterpret_cast<float*>(sbase + L::P);   // P^T element j of thread i: j * 128 + i
    const float scale_log2 = scale * LOG2E;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    if (ntiles > 0) mbar_wait(fullKV, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES, q0 = (qt0 + i % nqt) * BWD_BM;
      const uint32_t q_tile = base + L::Q + s * 2 * L::TILE, do_tile = q_tile + L::TILE;
      const float* st = reinterpret_cast<const float*>(sbase + L::STATS) + s * 2 * BWD_BM;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): keys x q rows
      float sc[BWD_BM / 2];
      wgmma_fence();
      mma_ss<HD>(sc, base + (wg == 0 ? L::K : L::V), wg == 0 ? q_tile : do_tile);
      wgmma_wait<0>();
      pin(sc);
      if (wg == 0) {
        const bool edge = q0 + BWD_BM > Sq || kv0 + BWD_BN > Sk || (causal && kv0 + BWD_BN - 1 > q0) ||
                          (window > 0 && q0 + BWD_BM - 1 - kv0 >= window);
#pragma unroll
        for (int n = 0; n < BWD_BM / 8; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fast_exp2(fmaf(sc[4 * n + e], scale_log2, -((e & 1) ? l.y : l.x)));
            if (edge && !keep(q0 + 8 * n + 2 * t + (e & 1), kv0 + key0 + 8 * (e >> 1), Sq, Sk,
                              causal, window))
              p = 0.f;
            sc[4 * n + e] = p;
          }
        }
        if (i > 0) named_sync(P_EMPTY);              // warpgroup 1 has read the last P^T
#pragma unroll
        for (int j = 0; j < BWD_BM / 2; ++j) pt[j * 128 + tid] = sc[j];
        named_arrive(P_FULL);
      } else {
        named_sync(P_FULL);
#pragma unroll
        for (int n = 0; n < BWD_BM / 8; ++n) {
          const float2 d = *reinterpret_cast<const float2*>(st + BWD_BM + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * n + e] = pt[(4 * n + e) * 128 + tid] * (sc[4 * n + e] - ((e & 1) ? d.y : d.x));
        }
        named_arrive(P_EMPTY);
      }
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), both bf16
      uint32_t a[BWD_BM / 16][4];
      pack_a<BWD_BM>(a, sc);
      pin(acc);
      pin(a);
      wgmma_fence();
      mma_rs<HD, BWD_BM>(acc, a, wg == 0 ? do_tile : q_tile);
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (wg == 0 && ntiles > 0) named_sync(P_EMPTY);   // pairs warpgroup 1's last arrival

    // ---- dK = scale sum, dV = sum: bf16 out, or this split's f32 partial ----
    const float mul = wg == 0 ? 1.f : scale;
    const size_t off = (size_t)kvh * Sk * HD + (size_t)kv0 * HD;
    if (splits == 1) {
      store_acc<HD>((wg == 0 ? dv : dk) + off, acc, key0, Sk - kv0, t, mul);
    } else {
      // partials [dK splits][dV splits] x (BKV, Sk, HD), unscaled
      const size_t n = (size_t)BKV * Sk * HD;
      store_acc<HD>(part + ((size_t)(wg == 0 ? splits : 0) + split) * n + off, acc, key0, Sk - kv0,
                    t, 1.f);
    }
  }
}

// dK = scale sum of the dK partials, dV = sum of the dV partials, in split
// order; n = BKV Sk HD (a multiple of 4), four elements a thread and step
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk, bf16* __restrict__ dv,
                        long long n, int splits, float scale) {
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < 2 * n;
       i += (long long)gridDim.x * blockDim.x * 4) {
    const int which = i >= n;                                  // 0 dK, 1 dV
    const long long j = i - which * n;
    const float* p = part + (long long)which * splits * n + j;
    float4 a = *reinterpret_cast<const float4*>(p);
    for (int s = 1; s < splits; ++s) {
      const float4 b = *reinterpret_cast<const float4*>(p + s * n);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const float m = which ? 1.f : scale;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>((which ? dv : dk) + j);
    out[0] = __floats2bfloat162_rn(a.x * m, a.y * m);
    out[1] = __floats2bfloat162_rn(a.z * m, a.w * m);
  }
}

// ---- dQ ----

// Shared memory of a dQ block: per consumer warpgroup Q and dO (64 rows),
// then a ring of 64-key K tiles and one of V tiles; at hd 256 V has one
// stage, so that the block fits (V is read first in a tile and released
// early, so its next load overlaps the rest of the tile)
template <int HD>
struct DqSmem {
  using W = Swizzle<HD>;
  static constexpr int VSTAGES = HD >= 256 ? 1 : 2;
  static constexpr int BOX = 64 * W::SW, TILE = W::NB * BOX;
  static constexpr int Q = 0;                                // consumer c: Q at Q + 2 c TILE, dO + TILE
  static constexpr int K = 2 * 2 * TILE;                     // K stage s at K + s TILE
  static constexpr int V = K + STAGES * TILE;                // V stage s at V + s TILE
  static constexpr int BAR = V + VSTAGES * TILE;
  // barriers: fullQ [2]; fullK, emptyK [STAGES]; fullV, emptyV [VSTAGES]
  static constexpr int BYTES = BAR + 8 * (2 + 2 * STAGES + 2 * VSTAGES) + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory");
};

// kv tiles [t0, t0 + n) of 64 keys that rows [r0, r1) see
__device__ __forceinline__ void kv_tiles(int r0, int r1, int Sk, int causal, int window, int& t0,
                                         int& n) {
  const int kb = window > 0 ? max(0, r0 - window + 1) : 0;
  const int ke = causal ? min(Sk, r1) : Sk;
  t0 = kb / BWD_BN;
  n = max(0, (ke + BWD_BN - 1) / BWD_BN - t0);
}

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bwd_dq_bf16_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv, __grid_constant__ const CUtensorMap tdo,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int BH, int G, int Sq, int Sk, int causal, int window,
                         float scale) {
  using L = DqSmem<HD>;
  using W = Swizzle<HD>;
  constexpr int BN = BWD_BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr int VS = L::VSTAGES;
  const uint32_t fullQ = base + L::BAR, fullK = fullQ + 16, emptyK = fullK + 8 * STAGES,
                 fullV = emptyK + 8 * STAGES, emptyV = fullV + 8 * VS;
  const int nq = (Sq + 2 * BWD_BM - 1) / (2 * BWD_BM);
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * 2 * BWD_BM;   // heaviest (latest) tiles first
  const int kvh = bh / G;
  int t0, n;
  kv_tiles(q0, min(Sq, q0 + 2 * BWD_BM), Sk, causal, window, t0, n);

  if (threadIdx.x == 0) {
    mbar_init(fullQ, 1);
    mbar_init(fullQ + 8, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(emptyK + 8 * s, 8);
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(fullV + 8 * s, 1);
      mbar_init(emptyV + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread loads Q and dO once, then the K / V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 2 * 128) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (q0 + c * BWD_BM >= Sq) continue;          // that warpgroup has no rows
        mbar_expect_tx(fullQ + 8 * c, 2 * L::TILE);
        const uint32_t qs = base + L::Q + c * 2 * L::TILE;
#pragma unroll
        for (int b = 0; b < W::NB; ++b) {
          tma_load_3d(qs + b * L::BOX, &tq, fullQ + 8 * c, b * W::BC, q0 + c * BWD_BM, bh);
          tma_load_3d(qs + L::TILE + b * L::BOX, &tdo, fullQ + 8 * c, b * W::BC, q0 + c * BWD_BM, bh);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, sv = i % VS, k0 = (t0 + i) * BN;
        if (i >= STAGES) mbar_wait(emptyK + 8 * s, ((i / STAGES) & 1) ^ 1);   // the stage's last use
        mbar_expect_tx(fullK + 8 * s, L::TILE);
#pragma unroll
        for (int b = 0; b < W::NB; ++b)
          tma_load_3d(base + L::K + s * L::TILE + b * L::BOX, &tk, fullK + 8 * s, b * W::BC, k0, kvh);
        if (i >= VS) mbar_wait(emptyV + 8 * sv, ((i / VS) & 1) ^ 1);
        mbar_expect_tx(fullV + 8 * sv, L::TILE);
#pragma unroll
        for (int b = 0; b < W::NB; ++b)
          tma_load_3d(base + L::V + sv * L::TILE + b * L::BOX, &tv, fullV + 8 * sv, b * W::BC, k0, kvh);
      }
    }
  } else {
    // ---- consumer warpgroup wg: q rows [r0, r0 + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * BWD_BM;
    const bool active = r0 < Sq;
    const int row0 = r0 + warp * 16 + g;             // rows of e = 0, 1; +8 for e = 2, 3
    const uint32_t q_tile = base + L::Q + wg * 2 * L::TILE, do_tile = q_tile + L::TILE;
    const float scale_log2 = scale * LOG2E;
    float lse2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = row0 + 8 * h < Sq;
      lse2[h] = in ? lse[(size_t)bh * Sq + row0 + 8 * h] * LOG2E : 0.f;
      dd[h] = in ? delta[(size_t)bh * Sq + row0 + 8 * h] : 0.f;
    }
    auto pass = [&](int i) {   // ring slots this warpgroup's rows do not need
      mbar_wait(fullK + 8 * (i % STAGES), (i / STAGES) & 1);
      if (lane == 0) mbar_arrive(emptyK + 8 * (i % STAGES));
      mbar_wait(fullV + 8 * (i % VS), (i / VS) & 1);
      if (lane == 0) mbar_arrive(emptyV + 8 * (i % VS));
    };
    // this warpgroup's kv tiles [wa, wb) of the block's [0, n)
    int wa = 0, wb = 0;
    if (active) {
      int wt0, wn;
      kv_tiles(r0, r0 + BWD_BM, Sk, causal, window, wt0, wn);
      wa = min(n, wt0 - t0);
      wb = max(wa, min(n, wt0 - t0 + wn));
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    if (active) mbar_wait(fullQ + 8 * wg, 0);
    for (int i = 0; i < wa; ++i) pass(i);
    for (int i = wa; i < wb; ++i) {
      const int s = i % STAGES, sv = i % VS, k0 = (t0 + i) * BN;
      const uint32_t k_tile = base + L::K + s * L::TILE, v_tile = base + L::V + sv * L::TILE;
      float sc[BN / 2], dp[BN / 2];
      mbar_wait(fullK + 8 * s, (i / STAGES) & 1);
      wgmma_fence();
      mma_ss<HD>(sc, q_tile, k_tile);          // S = Q K^T
      mbar_wait(fullV + 8 * sv, (i / VS) & 1);
      wgmma_fence();
      mma_ss<HD>(dp, do_tile, v_tile);         // dP = dO V^T
      wgmma_wait<1>();
      pin(sc);
      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > r0) ||
                        (window > 0 && r0 + BWD_BM - 1 - k0 >= window);
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[4 * n8 + e], scale_log2, -lse2[e >> 1]));
          if (edge && !keep(row0 + 8 * (e >> 1), k0 + 8 * n8 + 2 * t + (e & 1), Sq, Sk, causal, window))
            p = 0.f;
          sc[4 * n8 + e] = p;
        }
      wgmma_wait<0>();
      pin(dp);
      if (lane == 0) mbar_arrive(emptyV + 8 * sv);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) dp[j] = sc[j] * (dp[j] - dd[(j & 2) >> 1]);
      uint32_t a[BN / 16][4];
      pack_a<BN>(a, dp);
      pin(acc);
      pin(a);
      wgmma_fence();
      mma_rs<HD, BN>(acc, a, k_tile);              // dQ += dS K
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(emptyK + 8 * s);
    }
    for (int i = wb; i < n; ++i) pass(i);

    if (active) store_acc<HD>(dq + ((size_t)bh * Sq + r0) * HD, acc, warp * 16 + g, Sq - r0, t, scale);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, void* dq, void* dk, void* dv, float* scratch, int BH,
                        int BKV, int Sq, int Sk, int causal, int window, float scale,
                        cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tdo, tk, tv;
  if ((err = tensor_map<HD>(encode, &tq, q, Sq, BH, 64)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &tdo, dout, Sq, BH, 64)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &tk, k, Sk, BKV, BWD_BN)) != cudaSuccess) return err;
  if ((err = tensor_map<HD>(encode, &tv, v, Sk, BKV, BWD_BN)) != cudaSuccess) return err;
  static unsigned long long kv_ready = 0, q_ready = 0;
  if ((err = smem_limit_once(flash_bwd_dkdv_bf16_kernel<HD>, DkdvSmem<HD>::BYTES, kv_ready)) !=
      cudaSuccess)
    return err;
  if ((err = smem_limit_once(flash_bwd_dq_bf16_kernel<HD>, DqSmem<HD>::BYTES, q_ready)) !=
      cudaSuccess)
    return err;

  const int G = BH / BKV, splits = head_splits(BKV, G, Sk);
  float* part = splits > 1 ? scratch + delta_floats(BH, Sq) : nullptr;
  const long long kv_blocks = (long long)BKV * ((Sk + BWD_BN - 1) / BWD_BN) * splits;
  flash_bwd_dkdv_bf16_kernel<HD><<<(unsigned)kv_blocks, BF16_THREADS, DkdvSmem<HD>::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, scratch, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, BKV, G,
      splits, Sq, Sk, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = (long long)BKV * Sk * HD;
    const long long blocks = (2 * n / 4 + 255) / 256;
    flash_bwd_reduce_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long q_blocks = (long long)BH * ((Sq + 2 * BWD_BM - 1) / (2 * BWD_BM));
  flash_bwd_dq_bf16_kernel<HD><<<(unsigned)q_blocks, BF16_THREADS, DqSmem<HD>::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, scratch, static_cast<bf16*>(dq), BH, G, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs in the m16n8 accumulator layout, for the tight checks
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int F32_BM = 64;                   // q rows per tile (both kernels)

template <int HD>
struct F32Tiles {
  static constexpr int BN = HD >= 256 ? 32 : 64;   // keys per kv tile
  static constexpr int LD = HD + 4;                // rows padded by 16 bytes
};

// A ROWS x COLS output split into 16 x 8 tiles, NT consecutive tiles of one
// 16-row group per warp
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

// acc[j][e] += sum_{k < K} A(m0 + g + 8 (e >> 1), k) B(k, n0 + 8 j + 2 t + (e & 1))
// for j < NT (lane = 4 g + t). A(m, k) = As[m * lda + k]; B(k, n) =
// Bs[n * ldb + k] when B_NK, else Bs[k * ldb + n].
template <int NT, int K, bool B_NK>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const float* As, int lda,
                                        const float* Bs, int ldb, int m0, int n0, int g, int t) {
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

// rows [r0, r0 + nrows) of a (rows, HD) row-major array into shared memory
// with row stride ld; rows at or past `valid` are zero
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int r0, int valid,
                                          int nrows) {
  constexpr int CPR = HD / 4;
  for (int c = threadIdx.x; c < nrows * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < valid) val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * HD + col);
    *reinterpret_cast<float4*>(dst + r * ld + col) = val;
  }
}

template <int HD>
struct F32DkdvSmem {
  static constexpr int BN = F32Tiles<HD>::BN, LD = F32Tiles<HD>::LD;
  static constexpr int LDP = F32_BM + 4;             // rows of P^T, dS^T
  static constexpr size_t BYTES =
      ((size_t)(2 * BN + 2 * F32_BM) * LD + 2 * (size_t)BN * LDP + 2 * F32_BM) * sizeof(float);
};

// dK, dV: a block per (kv head, BN keys), looping over the G query heads
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int BKV, int G, int Sq,
                          int Sk, int causal, int window, float scale) {
  using L = F32DkdvSmem<HD>;
  constexpr int BN = L::BN, LD = L::LD, LDP = L::LDP, BM = F32_BM;
  using SA = Split<BN, BM>;                            // S^T, dP^T: BN x BM
  using SB = Split<BN, HD>;                            // dK, dV: BN x HD
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;                           // P^T  [key][q row]
  float* dSs = Ps + BN * LDP;                          // dS^T [key][q row]
  float* lse_s = dSs + BN * LDP;
  float* d_s = lse_s + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x % BKV;
  const int kv0 = (blockIdx.x / BKV) * BN;             // heaviest (earliest) tiles first
  const float* kb = k + (size_t)kvh * Sk * HD;
  const float* vb = v + (size_t)kvh * Sk * HD;
  load_rows<HD>(Ks, LD, kb, kv0, Sk, BN);
  load_rows<HD>(Vs, LD, vb, kv0, Sk, BN);

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
    const float* qb = q + bh * Sq * HD;
    const float* db = dout + bh * Sq * HD;
    for (int q0 = (q_lo / BM) * BM; q0 < q_hi; q0 += BM) {
      __syncthreads();                                 // the previous tile is fully read
      load_rows<HD>(Qs, LD, qb, q0, Sq, BM);
      load_rows<HD>(dOs, LD, db, q0, Sq, BM);
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
      warp_mm<SA::NT, HD, true>(s, Ks, LD, Qs, LD, am0, an0, g, t);
      warp_mm<SA::NT, HD, true>(dp, Vs, LD, dOs, LD, am0, an0, g, t);
#pragma unroll
      for (int j = 0; j < SA::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = am0 + g + 8 * (e >> 1), qc = an0 + 8 * j + 2 * t + (e & 1);
          const bool ok = keep(q0 + qc, kv0 + kr, Sq, Sk, causal, window);
          const float p = ok ? expf(s[j][e] * scale - lse_s[qc]) : 0.f;
          Ps[kr * LDP + qc] = p;
          dSs[kr * LDP + qc] = p * (dp[j][e] - d_s[qc]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q (scale at the end)
      warp_mm<SB::NT, BM, false>(acc_dv, Ps, LDP, dOs, LD, bm0, bn0, g, t);
      warp_mm<SB::NT, BM, false>(acc_dk, dSs, LDP, Qs, LD, bm0, bn0, g, t);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kv0 + bm0 + g + 8 * h;
    if (key >= Sk) continue;
    float* dkr = dk + ((size_t)kvh * Sk + key) * HD;
    float* dvr = dv + ((size_t)kvh * Sk + key) * HD;
#pragma unroll
    for (int j = 0; j < SB::NT; ++j) {
      const int col = bn0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(dkr + col) =
          make_float2(acc_dk[j][2 * h] * scale, acc_dk[j][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dvr + col) = make_float2(acc_dv[j][2 * h], acc_dv[j][2 * h + 1]);
    }
  }
}

template <int HD>
struct F32DqSmem {
  static constexpr int BN = F32Tiles<HD>::BN, LD = F32Tiles<HD>::LD;
  static constexpr int LDS = BN + 4;                 // rows of dS
  static constexpr size_t BYTES =
      ((size_t)(2 * F32_BM + 2 * BN) * LD + (size_t)F32_BM * LDS + 2 * F32_BM) * sizeof(float);
};

// dQ: a block per (head, 64 q rows), looping over the kv tiles they see
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int BH, int G, int Sq, int Sk, int causal,
                        int window, float scale) {
  using L = F32DqSmem<HD>;
  constexpr int BN = L::BN, LD = L::LD, LDS = L::LDS, BM = F32_BM;
  using SA = Split<BM, BN>;                            // S, dP: BM x BN
  using SB = Split<BM, HD>;                            // dQ: BM x HD
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;                           // dS [q row][key]
  float* lse_s = dSs + BM * LDS;
  float* d_s = lse_s + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (Sq + BM - 1) / BM;
  const size_t bh = blockIdx.x % BH;
  const int q0 = (nq - 1 - (int)(blockIdx.x / BH)) * BM;   // heaviest (latest) tiles first
  const float* kb = k + (bh / G) * Sk * HD;
  const float* vb = v + (bh / G) * Sk * HD;
  load_rows<HD>(Qs, LD, q + bh * Sq * HD, q0, Sq, BM);
  load_rows<HD>(dOs, LD, dout + bh * Sq * HD, q0, Sq, BM);
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
    load_rows<HD>(Ks, LD, kb, kv0, Sk, BN);
    load_rows<HD>(Vs, LD, vb, kv0, Sk, BN);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, this warp's 16 q rows x 8 NT keys
    float s[SA::NT][4], dp[SA::NT][4];
#pragma unroll
    for (int j = 0; j < SA::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mm<SA::NT, HD, true>(s, Qs, LD, Ks, LD, am0, an0, g, t);
    warp_mm<SA::NT, HD, true>(dp, dOs, LD, Vs, LD, am0, an0, g, t);
#pragma unroll
    for (int j = 0; j < SA::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = am0 + g + 8 * (e >> 1), kc = an0 + 8 * j + 2 * t + (e & 1);
        const bool ok = keep(q0 + qr, kv0 + kc, Sq, Sk, causal, window);
        const float p = ok ? expf(s[j][e] * scale - lse_s[qr]) : 0.f;
        dSs[qr * LDS + kc] = p * (dp[j][e] - d_s[qr]);
      }
    __syncthreads();

    // dQ += dS K (scale at the end)
    warp_mm<SB::NT, BN, false>(acc, dSs, LDS, Ks, LD, bm0, bn0, g, t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + bm0 + g + 8 * h;
    if (row >= Sq) continue;
    float* dqr = dq + (bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < SB::NT; ++j)
      *reinterpret_cast<float2*>(dqr + bn0 + 8 * j + 2 * t) =
          make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int HD>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, float* dq, float* dk, float* dv, const float* delta,
                       int BH, int BKV, int Sq, int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int BN = F32Tiles<HD>::BN;
  static unsigned long long kv_ready = 0, q_ready = 0;
  cudaError_t err;
  if ((err = smem_limit_once(flash_bwd_dkdv_f32_kernel<HD>, (int)F32DkdvSmem<HD>::BYTES,
                             kv_ready)) != cudaSuccess)
    return err;
  if ((err = smem_limit_once(flash_bwd_dq_f32_kernel<HD>, (int)F32DqSmem<HD>::BYTES, q_ready)) !=
      cudaSuccess)
    return err;
  const long long kv_blocks = (long long)BKV * ((Sk + BN - 1) / BN);
  flash_bwd_dkdv_f32_kernel<HD><<<(unsigned)kv_blocks, THREADS, F32DkdvSmem<HD>::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, BKV, BH / BKV, Sq, Sk, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long q_blocks = (long long)BH * ((Sq + F32_BM - 1) / F32_BM);
  flash_bwd_dq_f32_kernel<HD><<<(unsigned)q_blocks, THREADS, F32DqSmem<HD>::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dq, BH, BH / BKV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int is_bf16, const void* q, const void* k, const void* v, const void* o,
                      const float* lse, const void* dout, void* dq, void* dk, void* dv,
                      float* scratch, int BH, int BKV, int Sq, int Sk, int causal, int window,
                      float scale, cudaStream_t s) {
  const long long rows = (long long)BH * Sq;
  const unsigned d_blocks = (unsigned)((rows + D_WARPS - 1) / D_WARPS);
  if (is_bf16)
    flash_bwd_delta_kernel<bf16, HD><<<d_blocks, D_WARPS * 32, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), scratch, rows);
  else
    flash_bwd_delta_kernel<float, HD><<<d_blocks, D_WARPS * 32, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), scratch, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, dout, lse, dq, dk, dv, scratch, BH, BKV, Sq, Sk, causal,
                           window, scale, s);
  return launch_f32<HD>(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        scratch, BH, BKV, Sq, Sk, causal, window, scale, s);
}

}  // namespace

extern "C" {

// q, o, dout, dq (BH, Sq, hd); k, v, dk, dv (BKV, Sk, hd): contiguous,
// 16-byte aligned, all bf16 (is_bf16 1) or all f32 (0), on the current
// device. lse (BH, Sq) f32 from the forward. scratch: f32 scratch of
// kernels/flash_attention.py::bwd_scratch_floats floats (D, then the bf16
// path's split partials), 16-byte aligned. Launches its kernels on `stream`
// without synchronising; returns the first launch error.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const float* lse, const void* dout, void* dq, void* dk, void* dv,
                        float* scratch, int BH, int BKV, int Sq, int Sk, int hd, int is_bf16,
                        int causal, int window, float scale, void* stream) {
  if (BH <= 0 || BKV <= 0 || BH % BKV != 0 || Sq <= 0 || Sk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 32:
      return launch_hd<32>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 64:
      return launch_hd<64>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, BKV, Sq, Sk,
                           causal, window, scale, s);
    case 128:
      return launch_hd<128>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, BKV, Sq, Sk,
                            causal, window, scale, s);
    case 256:
      return launch_hd<256>(is_bf16, q, k, v, o, lse, dout, dq, dk, dv, scratch, BH, BKV, Sq, Sk,
                            causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
