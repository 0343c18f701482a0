// Pieces shared by the SSD forward (ssd.cu) and backward (ssd_bwd.cu) on
// Hopper (sm_90a): the problem's dimensions, the 3xTF32 tensor-core product
// (mma.sync m16n8k8 TF32 with each operand split big/small by cvt.rn, the
// small terms first) with its fragment loads, and cp.async loads of a
// chunk's rows, zero-filled past the chunk, the sequence and the width.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Dims {
  int b, s, h, n;
  int nk;     // n rounded up to 16, the MMA's depth and m-tile
  int Q;      // rows per chunk
  int nc;     // chunks
  int ntile;  // 64-row tiles per chunk, ceil(Q / TQ)
  int Qp;     // ntile * TQ, the row and column count of a cb tile
};

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core product and cp.async
// ---------------------------------------------------------------------------

// Round to TF32 (10 mantissa bits, to nearest even): one F2FP instruction
// on sm_90, where cvt.rna.tf32.f32 (ties away) compiles to three with an inf
// guard.
__device__ __forceinline__ uint32_t tf32_rn(float a) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small, each a TF32 value (13 low bits zero); a - big is exact
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = tf32_rn(a);
  small = tf32_rn(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[m][n] += a[m] . b[n] for M x N tiles in 3xTF32: small(a).big(b) +
// big(a).small(b) + big(a).big(b), the small terms first
template <int M, int N>
__device__ __forceinline__ void mma3(float (&acc)[M][N][4], const uint32_t (&ab)[M][4],
                                     const uint32_t (&as)[M][4], const uint32_t (&bb)[N][2],
                                     const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      mma_tf32(acc[m][n], as[m], bb[n]);
      mma_tf32(acc[m][n], ab[m], bs[n]);
      mma_tf32(acc[m][n], ab[m], bb[n]);
    }
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8) holds
// (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (8 x 8) holds (k t, n g),
// (k t+4, n g); the sum (16 x 8) holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1). `at(r, k)` reads the A element of tile row r and depth k.
template <class F>
__device__ __forceinline__ void load_a(uint32_t (&big)[4], uint32_t (&small)[4], int g, int t,
                                       F at) {
  split(at(g, t), big[0], small[0]);
  split(at(g + 8, t), big[1], small[1]);
  split(at(g, t + 4), big[2], small[2]);
  split(at(g + 8, t + 4), big[3], small[3]);
}
template <class F>
__device__ __forceinline__ void load_b(uint32_t (&big)[2], uint32_t (&small)[2], int g, int t,
                                       F at) {
  split(at(t, g), big[0], small[0]);
  split(at(t + 4, g), big[1], small[1]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

__device__ __forceinline__ int valid_rows(const Dims& d, int c) {
  return min(d.Q, d.s - c * d.Q);
}

// cp.async rows [r0, r0 + rows) of chunk c of a (b, s, [h,] width) array into
// a (rows, ld) shared tile, `cols` floats a row (a multiple of 4 >= width).
// Rows past the chunk or the sequence and columns past `width` are
// zero-filled; `stride` is the distance in floats between consecutive
// sequence rows and `off` the offset of the wanted head.
template <int NT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, const Dims& d,
                                          int bb, int c, int r0, int rows, int width, int cols,
                                          size_t stride, size_t off) {
  const int cpr = cols / 4, qv = valid_rows(d, c);
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NT) {
    const int r = idx / cpr, col = (idx % cpr) * 4, lr = r0 + r;
    const bool ok = lr < qv && col < width;
    cp_async16(dst + r * ld + col,
               ok ? src + ((size_t)bb * d.s + (size_t)c * d.Q + lr) * stride + off + col : src,
               ok);
  }
}

}  // namespace
