// Backward of the RG-LRU linear-recurrence scan for Hopper (sm_90a), f32,
// with a plain C interface (loaded from Python with ctypes).
//
// The gradient of the TPU kernel src/repro/kernels/rglru.py::rglru_scan_tpu
// (h_t = a_t * h_{t-1} + b_t over (B,S,C), h_0 = 0), which the JAX package
// takes through XLA (no custom_vjp). Given a, the forward's output h and dh:
//   g_t = dh_t + a_{t+1} * g_{t+1}   (g past the end is 0),
//   db_t = g_t,  da_t = g_t * h_{t-1}  (h_{-1} = 0, so da_0 = 0),
// everything f32. Its plain version is kernels/ref.py::rglru_scan_bwd_oracle.
//
// The forward's chained pass (csrc/rglru.cu), run in reverse time. A tile is
// T time steps of NTHREADS channels (one channel a thread); the carry walks
// from the last chunk to the first through one 64-bit word in device memory
// (L2) per (b, chunk, channel). The carry into chunk k is x = a_{t1} g_{t1},
// t1 the first step of chunk k + 1: the chunk after multiplies it, since it
// holds that a in registers, so no tile reads another chunk's a. A thread
//   1. loads its T a's and T dh's into registers (2T loads in flight);
//   2. computes its chunk's aggregate from x = 0, the reverse steps
//      g = x + dh_t, x = a_t g: the x that leaves the chunk from zero, and
//      the product of the chunk's a's (x is linear in the carry entering);
//   3. waits on the word of the chunk after (acquire): low half the carry,
//      high half the ready flag;
//   4. publishes the x that leaves this chunk, prod * x_in + x from zero, in
//      one 64-bit release store, for the chunk before;
//   5. only then runs its T steps backwards from x_in, writing db = g and
//      da = g * h_{t-1}, h_{t-1} read from h shifted by one step (the first
//      step of chunk k reads the last h of chunk k - 1).
// The last chunk, the only one that may be ragged, waits for nothing; the
// first publishes nothing.
//
// Blocks run in no order, and a block that waits on one that is not resident
// would wait forever. So a block takes its tile from an atomic counter, not
// from blockIdx, and tiles are numbered chunk-major from the last chunk: the
// tile a block waits on took its number earlier, so it has started and only
// waits on tiles numbered earlier still. The counter and the words live in
// the caller's scratch, which one memset on the same stream zeroes before the
// kernel.
//
// What bounds it: 3 FLOP per element against 20 bytes (a, h and dh read, da
// and db written), so the bytes: 335.5 MB at the recurrentgemma-9b training
// shape (B 2, S 2048, C 4096), 0.100 ms at 3.35 TB/s, 5/3 of the forward's
// 12 bytes an element. The pass moves those 20 bytes an element plus 8 bytes
// of word per (b, chunk, channel), written once and read once from L2.
// Neighbouring threads take neighbouring channels, so every warp load and
// store is 128 contiguous bytes; the ragged S and C edges are masked, never
// padded. T and NTHREADS are the forward's.
//
// Precision and determinism: each step rounds a * g, then + dh, as the plain
// version does (no fused multiply-add), so within a chunk the kernel repeats
// the plain version's arithmetic. The carry into a chunk is one fixed
// formula, the product of the chunk's a's times the carry into it plus its x
// from zero: f32 rounding of a few ulps of |g| at each chunk boundary, and
// the same bits on every call, whatever the timing. No float atomics.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 128;   // channels per tile
constexpr int T = 64;           // time steps per tile (a chunk)
constexpr unsigned long long READY = 1ULL << 32;   // the flag in a word's high half
// A wait that outlasts this many polls (seconds of sleeping) traps, so a
// broken hand-off fails the launch with an error instead of hanging the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// The carry that leaves the chunk after: spins on its word until the flag is set.
__device__ __forceinline__ float wait_carry(unsigned long long* word) {
  Word w(*word);
  unsigned long long v = w.load(cuda::memory_order_acquire);
  unsigned ns = 32;
  for (unsigned polls = 0; !(v & READY); ++polls) {
    if (polls == SPIN_LIMIT) __trap();
    __nanosleep(ns);
    ns = ns < 512 ? 2 * ns : ns;
    v = w.load(cuda::memory_order_acquire);
  }
  return __uint_as_float(static_cast<unsigned>(v));
}

__device__ __forceinline__ void publish(unsigned long long* word, float x) {
  Word(*word).store(READY | __float_as_uint(x), cuda::memory_order_release);
}

struct Dims {
  int B, S, C, nc, cblocks;   // nc = ceil(S / T) chunks, cblocks = ceil(C / NTHREADS)
};

// One channel's tile of n steps (n == T unless kFull is false, which only the
// last chunk is). a, h, dh, da and db step by C floats and point at the
// chunk's first step; has_prev says that h has a step before it (chunk k > 0).
// later and earlier are this channel's words of the chunk after (read) and of
// this chunk (written for the chunk before), null where there is none.
template <bool kFull>
__device__ __forceinline__ void bwd_tile(const float* __restrict__ a, const float* __restrict__ h,
                                         const float* __restrict__ dh, float* __restrict__ da,
                                         float* __restrict__ db, long long C, int n,
                                         bool has_prev, unsigned long long* later,
                                         unsigned long long* earlier) {
  float av[T], dv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (kFull || t < n) {
      av[t] = __ldg(a + t * C);
      dv[t] = __ldg(dh + t * C);
    }
  }
  float x = 0.0f;   // a_{t+1} g_{t+1} entering step t
  if (earlier) {
    float p = 1.0f, e = 0.0f;
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      if (kFull || t < n) {
        e = __fmul_rn(av[t], __fadd_rn(e, dv[t]));
        p = __fmul_rn(p, av[t]);
      }
    }
    if (later) x = wait_carry(later);
    publish(earlier, __fadd_rn(__fmul_rn(p, x), e));
  } else if (later) {
    x = wait_carry(later);
  }
#pragma unroll
  for (int t = T - 1; t >= 0; --t) {
    if (kFull || t < n) {
      const float g = __fadd_rn(x, dv[t]);
      const float hp = (t > 0 || has_prev) ? __ldg(h + (t - 1) * C) : 0.0f;
      db[t * C] = g;
      da[t * C] = __fmul_rn(g, hp);
      x = __fmul_rn(av[t], g);
    }
  }
}

// grid (nc * B * cblocks), one tile a block. words: (B, nc - 1, C); word
// k - 1 of a row hands the carry from chunk k to chunk k - 1.
__global__ void __launch_bounds__(NTHREADS)
rglru_bwd_chained_scan_kernel(const float* __restrict__ a, const float* __restrict__ h,
                              const float* __restrict__ dh, float* __restrict__ da,
                              float* __restrict__ db, unsigned* counter,
                              unsigned long long* words, Dims d) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(counter, 1u);
  __syncthreads();
  // chunk-major from the last chunk: every tile of chunk k comes before any
  // of chunk k - 1
  const int per_chunk = d.B * d.cblocks;
  const int k = d.nc - 1 - static_cast<int>(tile / per_chunk);
  const int r = tile % per_chunk;
  const int bi = r / d.cblocks;
  const int c = (r % d.cblocks) * NTHREADS + threadIdx.x;
  if (c >= d.C) return;   // past the barrier: nothing else synchronises
  const long long in = ((long long)bi * d.S + (long long)k * T) * d.C + c;
  const long long row = (long long)bi * (d.nc - 1);
  unsigned long long* later = k < d.nc - 1 ? words + (row + k) * d.C + c : nullptr;
  unsigned long long* earlier = k ? words + (row + k - 1) * d.C + c : nullptr;
  const int n = min(T, d.S - k * T);
  if (n == T)
    bwd_tile<true>(a + in, h + in, dh + in, da + in, db + in, d.C, n, k > 0, later, earlier);
  else
    bwd_tile<false>(a + in, h + in, dh + in, da + in, db + in, d.C, n, k > 0, later, earlier);
}

// 64-bit words of scratch for (B, S, C): the counter, then one per
// (b, chunk, channel) for every chunk but the first.
long long scratch_words(int B, int S, int C) {
  const long long nc = (S + T - 1) / T;
  return 1 + (long long)B * (nc > 0 ? nc - 1 : 0) * C;
}

}  // namespace

extern "C" {

// Scratch floats the caller provides for (B, S, C): 2 + 2 * B * (nc - 1) * C,
// nc = ceil(S / 64): the tile counter and the hand-off words, 8 bytes each.
long long rglru_bwd_scratch_floats(int B, int S, int C) {
  return 2 * scratch_words(B, S, C);
}

// a, h, dh, da, db (B,S,C): f32, contiguous, on the current device; scratch
// as above, 8-byte aligned. Zeroes the scratch and launches the kernel on
// `stream` without synchronising; returns the first error
// (cudaGetLastError()), or cudaErrorInvalidValue.
int rglru_scan_bwd(const void* a, const void* h, const void* dh, void* da, void* db,
                   void* scratch, int B, int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return cudaErrorInvalidValue;
  const Dims d{B, S, C, (S + T - 1) / T, (C + NTHREADS - 1) / NTHREADS};
  const long long tiles = (long long)d.nc * B * d.cblocks;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, 8 * scratch_words(B, S, C), st);
  if (err != cudaSuccess) return err;
  rglru_bwd_chained_scan_kernel<<<(unsigned)tiles, NTHREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(h), static_cast<const float*>(dh),
      static_cast<float*>(da), static_cast<float*>(db), reinterpret_cast<unsigned*>(words),
      words + 1, d);
  return cudaGetLastError();
}

const char* rglru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
