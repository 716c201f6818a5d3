// Shared pieces of the port's CUDA kernels (spmm.cu, fused.cu).
//
// Both kernels compute rows of A_w @ H (+ init) for a CSR matrix A whose
// edge weights w may be overridden per call. A group of TPR threads owns
// one output row; its lanes stride over the feature columns, and each
// output element sums its row's edges one by one in CSR order. The sum
// order is therefore fixed: no atomics, the same bits on every run.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace ppnp {

constexpr int kBlock = 256;  // threads per block, a multiple of every TPR

// Threads per row: the smallest of 8, 16, 32 that covers c columns (c=15
// packs two rows into a warp instead of idling 17 of its 32 lanes).
inline int threads_per_row(int c) { return c <= 8 ? 8 : (c <= 16 ? 16 : 32); }

// acc + sum over e in [beg, end) of w[e] * src[col[e] * c + j], in order.
// kBypassL1 reads src through L2 only (ld.global.cg): the fused kernel's
// src is written by other blocks earlier in the same launch, and its rows
// must never come from a stale L1 line or the read-only path.
template <bool kBypassL1>
__device__ __forceinline__ float row_dot(const int* __restrict__ col,
                                         const float* __restrict__ w,
                                         const float* src, int beg, int end,
                                         int c, int j, float acc) {
#pragma unroll 4
  for (int e = beg; e < end; ++e) {
    const float* p = src + static_cast<size_t>(col[e]) * c + j;
    const float x = kBypassL1 ? __ldcg(p) : __ldg(p);
    acc = fmaf(w[e], x, acc);
  }
  return acc;
}

}  // namespace ppnp

extern "C" const char* ppnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
