// RG-LRU linear-recurrence scan for Hopper (sm_90a), f32, with a plain C
// interface (loaded from Python with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::rglru_scan_tpu
// (Pallas, body `_kernel`) and computes the same function:
//   a, b (B,S,C) -> h (B,S,C), h_t = a_t * h_{t-1} + b_t elementwise over
//   the C channels, h_0 = 0, everything f32.
//
// The TPU walks time blocks in order on its sequential grid axis and carries
// h in VMEM scratch. Here one kernel makes a single pass, a chained scan: a
// tile is T time steps of NTHREADS channels (one channel a thread), and
// every tile loads its own a and b at once while the carry h walks from tile
// to tile in time through one 64-bit word in device memory (L2) per
// (b, chunk, channel). A thread
//   1. loads its T a's and T b's into registers (2T loads in flight);
//   2. computes its chunk's aggregate from h = 0, the chunk form of the
//      combine (a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2): the product of the
//      a's and the end state;
//   3. waits on the word of the chunk before (acquire), whose low half holds
//      the h that enters this chunk and whose high half is the ready flag;
//   4. publishes the h that leaves this chunk, prod * h_in + end state, in
//      one 64-bit release store;
//   5. only then runs its T steps from h_in over its registers, writing h.
// The first chunk waits for nothing and the last publishes nothing.
//
// Blocks run in no order, and a block that waits on one that is not resident
// would wait forever. So a block takes its tile from an atomic counter, not
// from blockIdx, and tiles are numbered chunk-major: the tile a block waits
// on took its number earlier, so it has started and only waits on earlier
// tiles in turn. The counter and the words live in the caller's scratch,
// which one memset on the same stream zeroes before the kernel.
//
// What bounds it: 2 FLOP per element against 12 bytes (a and b read, h
// written), so the bytes: 402.7 MB at the recurrentgemma-9b serving shape
// (B 4, S 2048, C 4096), 0.120 ms at 3.35 TB/s. The single pass moves those
// 12 bytes an element plus 8 bytes of word per (b, chunk, channel), written
// once and read once from L2. Neighbouring threads take neighbouring
// channels, so every warp load and store is 128 contiguous bytes; the
// ragged S and C edges are masked, never padded. T and NTHREADS were tuned
// on an H100 (PERF.md, K3's findings): 64 a's and 64 b's take 176 registers
// without spills; chunks of 32 or 48 steps were slower (a longer chain of
// hand-offs), and 32 to 256 channels a tile no faster.
//
// Precision and determinism: each step rounds a * h, then + b, as the plain
// version does (no fused multiply-add), so within a chunk the kernel repeats
// the plain version's arithmetic. The carry into a chunk is one fixed
// formula, the product of the T a's before it times the carry before that
// plus their end state from zero: f32 rounding of a few ulps of |h| at each
// chunk boundary, and the same bits on every call, whatever the timing.
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 128;   // channels per tile
constexpr int T = 64;           // time steps per tile (a chunk)
constexpr unsigned long long READY = 1ULL << 32;   // the flag in a word's high half
// A wait that outlasts this many polls (seconds of sleeping) traps, so a
// broken hand-off fails the launch with an error instead of hanging the card.
constexpr unsigned SPIN_LIMIT = 1u << 24;

// One step, a * h then + b, each rounded (no fused multiply-add), as the
// plain version rounds it.
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

using Word = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;

// The h that leaves the chunk before: spins on its word until the flag is set.
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

__device__ __forceinline__ void publish(unsigned long long* word, float h) {
  Word(*word).store(READY | __float_as_uint(h), cuda::memory_order_release);
}

struct Dims {
  int B, S, C, nc, cblocks;   // nc = ceil(S / T) chunks, cblocks = ceil(C / NTHREADS)
};

// One channel's tile of n steps (n == T unless kFull is false, which only the
// last chunk is). a, b and out step by C floats; prev and next are this
// channel's words of the chunk before and of this chunk, null where there is
// none.
template <bool kFull>
__device__ __forceinline__ void scan_tile(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          float* __restrict__ out, long long C, int n,
                                          unsigned long long* prev, unsigned long long* next) {
  float av[T], bv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (kFull || t < n) {
      av[t] = __ldg(a + t * C);
      bv[t] = __ldg(b + t * C);
    }
  }
  float h = 0.0f;
  if (kFull && next) {
    float p = 1.0f, e = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      e = step(av[t], e, bv[t]);
      p = __fmul_rn(p, av[t]);
    }
    if (prev) h = wait_carry(prev);
    publish(next, step(p, h, e));
  } else if (prev) {
    h = wait_carry(prev);
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (kFull || t < n) {
      h = step(av[t], h, bv[t]);
      out[t * C] = h;
    }
  }
}

// grid (nc * B * cblocks), one tile a block. words: (B, nc - 1, C).
__global__ void __launch_bounds__(NTHREADS)
rglru_chained_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out, unsigned* counter,
                          unsigned long long* words, Dims d) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(counter, 1u);
  __syncthreads();
  // chunk-major: every tile of chunk k comes before any of chunk k + 1
  const int per_chunk = d.B * d.cblocks;
  const int k = tile / per_chunk, r = tile % per_chunk;
  const int bi = r / d.cblocks;
  const int c = (r % d.cblocks) * NTHREADS + threadIdx.x;
  if (c >= d.C) return;   // past the barrier: nothing else synchronises
  const long long in = ((long long)bi * d.S + (long long)k * T) * d.C + c;
  const long long row = (long long)bi * (d.nc - 1);
  unsigned long long* prev = k ? words + (row + k - 1) * d.C + c : nullptr;
  unsigned long long* next = k < d.nc - 1 ? words + (row + k) * d.C + c : nullptr;
  const int n = min(T, d.S - k * T);
  if (n == T)
    scan_tile<true>(a + in, b + in, out + in, d.C, n, prev, next);
  else
    scan_tile<false>(a + in, b + in, out + in, d.C, n, prev, next);
}

// 64-bit words of scratch for (B, S, C): the counter, then one per
// (b, chunk, channel) for every chunk but the last.
long long scratch_words(int B, int S, int C) {
  const long long nc = (S + T - 1) / T;
  return 1 + (long long)B * (nc > 0 ? nc - 1 : 0) * C;
}

}  // namespace

extern "C" {

// Scratch floats the caller provides for (B, S, C): 2 + 2 * B * (nc - 1) * C,
// nc = ceil(S / 64): the tile counter and the hand-off words, 8 bytes each.
long long rglru_scratch_floats(int B, int S, int C) {
  return 2 * scratch_words(B, S, C);
}

// a, b, h (B,S,C): f32, contiguous, on the current device; scratch as above,
// 8-byte aligned. Zeroes the scratch and launches the kernel on `stream`
// without synchronising; returns the first error (cudaGetLastError()), or
// cudaErrorInvalidValue.
int rglru_scan_fwd(const void* a, const void* b, void* h, void* scratch, int B, int S, int C,
                   void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return cudaErrorInvalidValue;
  const Dims d{B, S, C, (S + T - 1) / T, (C + NTHREADS - 1) / NTHREADS};
  const long long tiles = (long long)d.nc * B * d.cblocks;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, 8 * scratch_words(B, S, C), st);
  if (err != cudaSuccess) return err;
  rglru_chained_scan_kernel<<<(unsigned)tiles, NTHREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h),
      reinterpret_cast<unsigned*>(words), words + 1, d);
  return cudaGetLastError();
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
