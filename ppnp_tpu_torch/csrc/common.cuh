// Shared pieces of the port's CUDA kernels (spmm.cu, fused.cu, masks.cu).
//
// The SpMM kernels compute rows of A_w @ H (+ init) for a CSR matrix A
// whose edge weights w may be overridden per call. Each output element
// sums its row's edges one by one in CSR order, so the sum order is fixed:
// no atomics, the same bits on every run. spmm.cu and fused.cu state
// their layouts.
//
// The mask kernels draw with threefry2x32, the 20-round Threefry-2x32 of
// ppnp_tpu/ops/hashrng.py (and of jax.random), on uint32 registers.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace ppnp {

constexpr int kBlock = 256;  // threads per block, a multiple of every TPR

// Threads per row: the smallest of 8, 16, 32 that covers c columns (c=15
// packs two rows into a warp instead of idling 17 of its 32 lanes).
inline int threads_per_row(int c) { return c <= 8 ? 8 : (c <= 16 ? 16 : 32); }

// acc + sum over e in [beg, end) of w[e] * src[col[e] * c + j], in order
// (src read through the read-only path: it is not written in the launch).
__device__ __forceinline__ float row_dot(const int* __restrict__ col,
                                         const float* __restrict__ w,
                                         const float* src, int beg, int end,
                                         int c, int j, float acc) {
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const float* p = src + static_cast<size_t>(col[e]) * c + j;
    const float x = __ldg(p);
    acc = fmaf(w[e], x, acc);
  }
  return acc;
}

// Threefry-2x32(key = (k0, k1), counter = (c0, c1)): 20 rounds with the
// key schedule (k0, k1, k2 = k0 ^ k1 ^ 0x1BD11BDA, computed once per key
// by the caller) injected every 4 rounds; all arithmetic wraps at 2^32.
__device__ __forceinline__ uint2 threefry2x32(unsigned k0, unsigned k1,
                                              unsigned k2, unsigned c0,
                                              unsigned c1) {
  const unsigned ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = c0 + ks[0];
  unsigned x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[i % 2][j]);  // rotate left
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<unsigned>(i + 1);
  }
  return make_uint2(x0, x1);
}

}  // namespace ppnp

extern "C" const char* ppnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
