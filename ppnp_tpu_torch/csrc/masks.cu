// Dropout masks drawn on the card, bit for bit the draws of the JAX
// package: Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU the masks were XLA element-wise
// ops over per-slot edge ids (ppnp_tpu/ops/dropout.py: edge_dropout_by_id,
// dropout). Their plain PyTorch versions, ppnp_tpu_torch/kernels/masks.py,
// run the same Threefry in int64 torch ops (about 100 of them per draw),
// which is the CPU path; on the card one launch does the whole draw.
//
// edge_masks_kernel: K planes of id-keyed edge-dropout weights for BOTH
// layouts of one operator (A and its transpose A^T, or X and X^T) in one
// launch. An entry at (r, c) of a forward layout is edge r * span + c; an
// entry at (r, c) of a transposed layout is edge c * span + r, the id of
// the same edge in the forward matrix, so both layouts keep and drop the
// same edges without any gather between them. Edge e of plane p keeps its
// weight iff the first Threefry word of (key_p; id_hi, id_lo) is below
// `thresh`, and then is scale * (val / keep), rounded in that order as
// the JAX package rounds (1 - alpha) * (e_w / keep).
//
// Bound on this card: operations. Per plane and layout each edge costs one
// Threefry (20 rounds, ~100 integer operations) against 12 bytes read and
// 4 written: at MS Academic (206,015 edges of A, K = 10, two layouts) that
// is ~4.1 M Threefry calls, ~0.4 G integer operations (~25 us at the
// card's ~17 T int32 operations/s) against ~8 MB (~2.5 us).
//
// Design: a group of 8 threads per row (CSR rows give (r, c) with no
// stored ids; MS Academic rows average 11 entries), lanes over the row's
// entries so neighbouring lanes write neighbouring floats, planes in an
// inner loop; rows of A come first in the grid, then rows of A^T. The keys
// ride in the launch arguments (at most kMaxKeys planes per launch; the
// wrapper launches again beyond that).
//
// dropout_mask_kernel: the keep mask of dense dropout. jax.random.bits
// draws one 32-bit word per flat index i of `lead + (ceil(last / 4),)`
// (out0 ^ out1 of Threefry(key; i >> 32, i & 0xFFFFFFFF)); byte b of word
// w is element 4 w + b of the row, kept iff the byte is below `thresh`
// (keep rounded to 1/256). One thread per word writes its 4 mask bytes.
#include "common.cuh"

namespace {

constexpr int kMaskTpr = 8;
constexpr int kMaxKeys = 64;

struct Keys {
  unsigned k[2 * kMaxKeys];
};

struct Layout {
  const int* row_ptr;
  const int* col;
  const float* val;
  float* out;  // n_keys planes of nnz weights
  int n_rows;
  int nnz;
  int transposed;
};

__device__ __forceinline__ void mask_row(const Layout& l, int row, int lane,
                                         long long span, const Keys& keys,
                                         int n_keys, unsigned thresh,
                                         float keep, float scale) {
  const int beg = l.row_ptr[row];
  const int end = l.row_ptr[row + 1];
  for (int e = beg + lane; e < end; e += kMaskTpr) {
    const long long c = l.col[e];
    const unsigned long long id = static_cast<unsigned long long>(
        l.transposed ? c * span + row : static_cast<long long>(row) * span + c);
    const unsigned hi = static_cast<unsigned>(id >> 32);
    const unsigned lo = static_cast<unsigned>(id & 0xFFFFFFFFull);
    const float w = __fmul_rn(scale, __fdiv_rn(l.val[e], keep));
    for (int p = 0; p < n_keys; ++p) {
      const uint2 b = ppnp::threefry2x32(keys.k[2 * p], keys.k[2 * p + 1], hi,
                                         lo);
      l.out[static_cast<size_t>(p) * l.nnz + e] = b.x < thresh ? w : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(ppnp::kBlock)
edge_masks_kernel(Layout a, Layout b, long long span, Keys keys, int n_keys,
                  unsigned thresh, float keep, float scale) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long row = t / kMaskTpr;
  const int lane = static_cast<int>(t % kMaskTpr);
  if (row < a.n_rows) {
    mask_row(a, static_cast<int>(row), lane, span, keys, n_keys, thresh, keep,
             scale);
  } else if (row < static_cast<long long>(a.n_rows) + b.n_rows) {
    mask_row(b, static_cast<int>(row - a.n_rows), lane, span, keys, n_keys,
             thresh, keep, scale);
  }
}

__global__ void __launch_bounds__(ppnp::kBlock)
dropout_mask_kernel(unsigned k0, unsigned k1, long long n_rows, int last,
                    int n_words, unsigned thresh,
                    unsigned char* __restrict__ mask) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n_rows * n_words) return;
  const uint2 b = ppnp::threefry2x32(
      k0, k1, static_cast<unsigned>(static_cast<unsigned long long>(i) >> 32),
      static_cast<unsigned>(i & 0xFFFFFFFFll));
  const unsigned word = b.x ^ b.y;
  const long long row = i / n_words;
  const int j0 = static_cast<int>(i % n_words) * 4;
  unsigned char* dst = mask + row * last;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (j0 + k < last) dst[j0 + k] = ((word >> (8 * k)) & 0xFFu) < thresh;
  }
}

}  // namespace

// Planes of both layouts in one launch on `stream`; returns a CUDA error
// code (0: the launch was accepted). `keys` is a host array of 2 * n_keys
// words, n_keys <= 64. A layout with n_rows == 0 is skipped.
extern "C" int ppnp_edge_masks(
    const int* row_ptr, const int* col, const float* val, float* out,
    int n_rows, int nnz, int transposed, const int* row_ptr_t,
    const int* col_t, const float* val_t, float* out_t, int n_rows_t,
    int nnz_t, int transposed_t, long long span, const unsigned* keys,
    int n_keys, unsigned thresh, float keep, float scale, int device,
    void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Keys k{};
  for (int i = 0; i < 2 * n_keys; ++i) k.k[i] = keys[i];
  const Layout a{row_ptr, col, val, out, n_rows, nnz, transposed};
  const Layout b{row_ptr_t, col_t, val_t, out_t, n_rows_t, nnz_t,
                 transposed_t};
  const long long threads =
      (static_cast<long long>(n_rows) + n_rows_t) * kMaskTpr;
  if (threads == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((threads + ppnp::kBlock - 1) / ppnp::kBlock);
  edge_masks_kernel<<<blocks, ppnp::kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, b, span, k, n_keys, thresh, keep, scale);
  return static_cast<int>(cudaGetLastError());
}

// The (n_rows, last) keep mask of dense dropout, as bytes 0/1, in one
// launch on `stream`; returns a CUDA error code.
extern "C" int ppnp_dropout_mask(unsigned k0, unsigned k1, long long n_rows,
                                 int last, unsigned thresh,
                                 unsigned char* mask, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_words = (last + 3) / 4;
  const long long threads = n_rows * n_words;
  if (threads == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((threads + ppnp::kBlock - 1) / ppnp::kBlock);
  dropout_mask_kernel<<<blocks, ppnp::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n_rows, last, n_words, thresh, mask);
  return static_cast<int>(cudaGetLastError());
}
