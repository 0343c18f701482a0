// RG-LRU linear-recurrence scan for Hopper (sm_90a), f32, with a plain C
// interface (loaded from Python with ctypes).
//
// Replaces the TPU kernel src/repro/kernels/rglru.py::rglru_scan_tpu
// (Pallas, body `_kernel`) and computes the same function:
//   a, b (B,S,C) -> h (B,S,C), h_t = a_t * h_{t-1} + b_t elementwise over
//   the C channels, h_0 = 0, everything f32.
//
// The TPU walks time blocks in order on its sequential grid axis and carries
// h in VMEM scratch. Blocks on the card run in no order, so the time axis is
// cut into chunks of T steps and one call is three kernels on one stream, the
// chunked form of the combine (a1, b1) o (a2, b2) = (a1 a2, b1 a2 + b2):
//   1. rglru_chunk_kernel, one thread per (b, chunk, c) for every chunk but
//      the last: the chunk's product of a and its end state from h = 0;
//   2. rglru_carry_kernel, one thread per (b, c): walks the chunks in order
//      and turns each chunk's (product, end state) into the h that leaves it,
//      in place;
//   3. rglru_scan_kernel, one thread per (b, chunk, c): the recurrence again
//      from the h that enters its chunk (0 for the first), writing h.
//   One thread per (b, c) walking all of S would give 16,384 threads at the
//   recurrentgemma-9b serving shape (B 4, S 2048, C 4096): too few loads in
//   flight to reach the card's memory rate. With T = 64 kernels 1 and 3 run
//   524,288 threads. The wrapper counts the three as one launch.
//
// What bounds it: 2 FLOP per element against 12 bytes (a and b read, h
// written), so the bytes: 402.7 MB at the serving shape, 0.120 ms at
// 3.35 TB/s. This design reads a and b twice (kernels 1 and 3), 5/3 of the
// bytes counted. What it does about that:
//   * neighbouring threads take neighbouring channels, so every warp load and
//     store is 128 contiguous bytes;
//   * a and b do not depend on h, so each thread loads U steps ahead into
//     registers before it runs their recurrence, keeping 2U loads in flight;
//   * kernel 1 skips the last chunk, whose end state nothing needs;
//   * kernel 3 takes the (b, chunk) blocks in the reverse of kernel 1's
//     order, so it starts on the data kernel 1 read last, which the 50 MB L2
//     may still hold;
//   * the ragged S and C edges are masked in the kernels, never padded.
//   A single pass (a chained scan whose blocks pass their carry on through a
//   flag in device memory) would read a and b once; that is later speed work.
//
// Precision: each step rounds a * h, then + b, as the plain version does
// (no fused multiply-add), so within a chunk the kernel repeats the plain
// version's arithmetic. The carry into a chunk is a product of up to T a's
// times the carry before it plus the chunk's end state from zero: f32
// rounding of a few ulps of |h| at each chunk boundary.
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 128;   // channels per block
constexpr int T = 64;           // time steps per chunk
constexpr int U = 8;            // steps loaded ahead per thread

// One step, a * h then + b, each rounded (no fused multiply-add), as the
// plain version rounds it.
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// The recurrence over n steps of one channel from h, returning the last h;
// a, b and out step by C floats. Writes every h to `out` when kStore, and
// the product of the a's to *prod when kProd.
template <bool kStore, bool kProd>
__device__ __forceinline__ float walk(const float* __restrict__ a, const float* __restrict__ b,
                                      float* __restrict__ out, long long C, int n, float h,
                                      float* prod) {
  float p = 1.0f;
  int t = 0;
  for (; t + U <= n; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = __ldg(a + (t + u) * C);
      bv[u] = __ldg(b + (t + u) * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = step(av[u], h, bv[u]);
      if (kProd) p *= av[u];
      if (kStore) out[(t + u) * C] = h;
    }
  }
  for (; t < n; ++t) {
    const float at = __ldg(a + t * C);
    h = step(at, h, __ldg(b + t * C));
    if (kProd) p *= at;
    if (kStore) out[t * C] = h;
  }
  if (kProd) *prod = p;
  return h;
}

struct Dims {
  int B, S, C, nc;   // nc = ceil(S / T) chunks
};

// grid (ceil(C / NTHREADS), nc - 1, B). prod, hend: (B, nc - 1, C).
__global__ void rglru_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ prod, float* __restrict__ hend, Dims d) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= d.C) return;
  const int k = blockIdx.y, bi = blockIdx.z;
  const long long in = ((long long)bi * d.S + (long long)k * T) * d.C + c;
  const long long sc = ((long long)bi * (d.nc - 1) + k) * d.C + c;
  float p;
  hend[sc] = walk<false, true>(a + in, b + in, nullptr, d.C, T, 0.0f, &p);
  prod[sc] = p;
}

// grid (ceil(B * C / NTHREADS)). On return hend[b, k, c] is h at the last
// step of chunk k: the carry into chunk k + 1.
__global__ void rglru_carry_kernel(const float* __restrict__ prod, float* __restrict__ hend,
                                   Dims d) {
  const long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= (long long)d.B * d.C) return;
  const long long bi = i / d.C, c = i % d.C;
  const long long base = bi * (d.nc - 1) * d.C + c;
  float h = 0.0f;
  for (int k = 0; k < d.nc - 1; ++k) {
    const long long j = base + (long long)k * d.C;
    h = step(prod[j], h, hend[j]);
    hend[j] = h;
  }
}

// grid (ceil(C / NTHREADS), nc, B), (b, chunk) taken in reverse.
__global__ void rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  const float* __restrict__ hend, float* __restrict__ out,
                                  Dims d) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= d.C) return;
  const int k = d.nc - 1 - blockIdx.y, bi = d.B - 1 - blockIdx.z;
  const float h0 = k ? hend[((long long)bi * (d.nc - 1) + k - 1) * d.C + c] : 0.0f;
  const long long in = ((long long)bi * d.S + (long long)k * T) * d.C + c;
  const int n = min(T, d.S - k * T);
  walk<true, false>(a + in, b + in, out + in, d.C, n, h0, nullptr);
}

}  // namespace

extern "C" {

// Scratch floats the caller provides for (B, S, C): 2 * B * (nc - 1) * C,
// nc = ceil(S / 64); none when S <= 64.
long long rglru_scratch_floats(int B, int S, int C) {
  const long long nc = (S + T - 1) / T;
  return 2LL * B * (nc > 0 ? nc - 1 : 0) * C;
}

// a, b, h (B,S,C): f32, contiguous, on the current device; scratch as above.
// Launches the kernels on `stream` without synchronising; returns the first
// launch error (cudaGetLastError()), or cudaErrorInvalidValue.
int rglru_scan_fwd(const void* a, const void* b, void* h, void* scratch, int B, int S, int C,
                   void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return cudaErrorInvalidValue;
  const Dims d{B, S, C, (S + T - 1) / T};
  if (d.nc > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fa = static_cast<const float*>(a), *fb = static_cast<const float*>(b);
  float* fh = static_cast<float*>(h);
  float* prod = static_cast<float*>(scratch);
  float* hend = prod + (long long)B * (d.nc - 1) * C;
  const int cblocks = (C + NTHREADS - 1) / NTHREADS;
  cudaError_t err;
  if (d.nc > 1) {
    rglru_chunk_kernel<<<dim3(cblocks, d.nc - 1, B), NTHREADS, 0, st>>>(fa, fb, prod, hend, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long nbc = ((long long)B * C + NTHREADS - 1) / NTHREADS;
    if (nbc > 0x7fffffffLL) return cudaErrorInvalidValue;
    rglru_carry_kernel<<<(unsigned)nbc, NTHREADS, 0, st>>>(prod, hend, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  rglru_scan_kernel<<<dim3(cblocks, d.nc, B), NTHREADS, 0, st>>>(fa, fb, hend, fh, d);
  return cudaGetLastError();
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
