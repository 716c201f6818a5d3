// Dropout masks drawn on the card, bit for bit the draws of the JAX
// package: Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU the masks were XLA element-wise
// ops over per-slot edge ids (ppnp_tpu/ops/dropout.py:59
// edge_dropout_by_id, :22 dropout). Their plain PyTorch versions,
// ppnp_tpu_torch/kernels/masks.py, run the same Threefry in int64 torch
// ops (about 100 of them per draw), which is the CPU path; on the card
// one launch does every key of a call.
//
// edge_masks_kernel: K planes of id-keyed edge-dropout weights for BOTH
// layouts of one operator (A and its transpose A^T, or X and X^T) in one
// cooperative launch. An entry at (r, c) of a forward layout is edge
// r * span + c. Edge e of plane p keeps its weight iff the first Threefry
// word of (key_p; id_hi, id_lo) is below `thresh`, and then is scale *
// (val / keep), rounded in that order as the JAX package rounds (1 -
// alpha) * (e_w / keep). A^T holds the same edges with the same values
// (entry j of A^T is entry fwd_pos[j] of A, ops/sparse.py csr_transpose),
// so each (plane, edge) is drawn ONCE:
//   pass 1, over A's entries: the entry's row from `rows` (no search of
//     row_ptr), its id, then for each plane a draw, A's weight or 0
//     stored coalesced, and the keep bit packed into the entry's word of
//     `bits` (up to 32 planes a word, entry-major);
//   grid barrier (every block resident);
//   pass 2, over A^T's entries: the entry's bit words read at fwd_pos[j]
//     (one scattered read per 32 planes, not one per plane), A^T's weight
//     or 0 stored coalesced in each plane.
// A single pass that scatters each plane's weight to A^T's position
// instead costs one random 4-byte write per plane and edge, which L2
// takes well below the draw rate (PERF.md: 2x slower at 10 planes, 6x at
// 100).
//
// Bound on this card: the larger of bytes and integer operations. nvcc
// builds a draw of the first word into 63 32-bit integer instructions
// (chip_smoke.py counts them in the SASS): 47 on the 64 INT32 lanes an SM
// (IADD3, LOP3, SHF: 132 x 64 x 1.98 GHz = 16.7 T/s) and 16 adds as
// IMAD.IADD on the FMA pipe, which runs beside them. At MS Academic
// (206,015 edges of A) and K = 10 the 2.06 M draws take 5.8 us of INT32
// lanes and the bytes (A's rows, cols and values, A^T's values and
// fwd_pos in, 2 x K planes out, ~20 MB) 6.2 us; at K = 100 the draws
// bind (58 us). Past them, a launch pays its fixed start (~3 us), the
// barrier and the drain of pass 1's stores before it (~2 us), and pass
// 2's K planes of stores.
//
// Design: block b of B = (SMs x k) owns the units [U b / B, U (b + 1) /
// B) of U = nnz x (words of 32 planes), so every SM gets the same number
// of draws whatever the row lengths; k is the fewest resident blocks per
// SM that give each thread about one unit (at most the occupancy). The
// plane loop is unrolled twice. The keys ride in the launch arguments
// with their schedule's third word (at most kMaxKeys planes per launch;
// the wrapper launches again beyond that).
//
// dropout_masks_kernel: the keep masks of dense dropout for G keys in one
// launch. jax.random.bits draws one 32-bit word per flat index i of
// `lead + (ceil(last / 4),)` (out0 ^ out1 of Threefry(key; i >> 32, i &
// 0xFFFFFFFF)); byte b of word w is element 4 w + b of the row, kept iff
// the byte is below `thresh` (keep rounded to 1/256). Plane g (blockIdx.y)
// draws from key g with i restarting at `word_offset`: a row-sharded rank
// draws rows [lo, hi) of the global array as the flat words [lo *
// ceil(last / 4), hi * ceil(last / 4)) of the whole draw (64-bit, so the
// high counter word is set past 2^32 words). One thread per word writes its
// 4 mask bytes, as one 32-bit store when rows are a multiple of 4 bytes.
// Bound: operations, one draw of both words per word, 50 instructions on
// the INT32 lanes (0.88 us a 18,331 x 64 plane).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxKeys = 256;
constexpr int kWordPlanes = 32;  // keep bits per word of `bits`

// key p is (k[3p], k[3p + 1]); k[3p + 2] is its schedule's third word
struct Keys {
  unsigned k[3 * kMaxKeys];
};

struct EdgeArgs {
  const int* rows;  // A, the layout that is drawn: each entry's row
  const int* col;
  const float* val;
  float* out;  // n_keys planes of nnz weights
  int nnz;
  int transposed;
  long long span;
  const int* pos;      // fwd_pos of A^T
  const float* val_t;  // A^T's values; null: A alone
  float* out_t;        // n_keys planes of A^T's nnz weights
  unsigned* bits;      // nnz x n_words keep-bit words
  int n_keys;
  int n_words;    // ceil(n_keys / per_word)
  int per_word;   // planes per word: ceil(n_keys / n_words) <= 32
  unsigned thresh;
  float keep;
  float scale;
};

__device__ __forceinline__ float weight(float val, float keep, float scale) {
  return __fmul_rn(scale, __fdiv_rn(val, keep));
}

__global__ void __launch_bounds__(ppnp::kBlock)
edge_masks_kernel(EdgeArgs a, const __grid_constant__ Keys keys) {
  const bool two = a.val_t != nullptr;
  const long long units = static_cast<long long>(a.nnz) * a.n_words;
  const long long beg = units * blockIdx.x / gridDim.x;
  const long long end = units * (blockIdx.x + 1) / gridDim.x;
  long long u = beg + threadIdx.x;
  int w = static_cast<int>(u / a.nnz);
  int e = static_cast<int>(u - static_cast<long long>(w) * a.nnz);
  for (; u < end; u += ppnp::kBlock) {
    const long long row = __ldg(a.rows + e);
    const long long c = __ldg(a.col + e);
    const unsigned long long id = static_cast<unsigned long long>(
        a.transposed ? c * a.span + row : row * a.span + c);
    const unsigned hi = static_cast<unsigned>(id >> 32);
    const unsigned lo = static_cast<unsigned>(id & 0xFFFFFFFFull);
    const float wv = weight(__ldg(a.val + e), a.keep, a.scale);
    const int p0 = w * a.per_word;
    const int p1 = min(p0 + a.per_word, a.n_keys);
    unsigned word = 0;
#pragma unroll 2
    for (int p = p0; p < p1; ++p) {
      const bool kept = ppnp::threefry2x32(keys.k[3 * p], keys.k[3 * p + 1],
                                           keys.k[3 * p + 2], hi, lo)
                            .x < a.thresh;
      const float v = kept ? wv : 0.0f;
      a.out[static_cast<size_t>(p) * a.nnz + e] = v;
      word |= static_cast<unsigned>(kept) << (p - p0);
    }
    if (two) a.bits[static_cast<size_t>(e) * a.n_words + w] = word;
    long long next = static_cast<long long>(e) + ppnp::kBlock;
    for (; next >= a.nnz; next -= a.nnz) ++w;
    e = static_cast<int>(next);
  }
  if (!two) return;
  cg::this_grid().sync();
  // pass 2: bits were written in this launch, so they are read from L2
  const long long stride = static_cast<long long>(gridDim.x) * ppnp::kBlock;
  for (long long j = static_cast<long long>(blockIdx.x) * ppnp::kBlock +
                     threadIdx.x;
       j < a.nnz; j += stride) {
    const unsigned* src = a.bits + static_cast<size_t>(__ldg(a.pos + j)) *
                                       a.n_words;
    const float wv = weight(__ldg(a.val_t + j), a.keep, a.scale);
    for (int ww = 0; ww < a.n_words; ++ww) {
      const unsigned word = __ldcg(src + ww);
      const int p0 = ww * a.per_word;
      const int p1 = min(p0 + a.per_word, a.n_keys);
      for (int p = p0; p < p1; ++p) {
        a.out_t[static_cast<size_t>(p) * a.nnz + j] =
            (word >> (p - p0)) & 1u ? wv : 0.0f;
      }
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(ppnp::kBlock)
dropout_masks_kernel(const __grid_constant__ Keys keys, unsigned plane_words,
                     int n_words, int last, long long plane_bytes,
                     unsigned thresh, unsigned long long word_offset,
                     unsigned char* __restrict__ mask) {
  const unsigned i = blockIdx.x * ppnp::kBlock + threadIdx.x;
  if (i >= plane_words) return;
  const int g = blockIdx.y;
  const unsigned long long ctr = word_offset + i;
  const uint2 b = ppnp::threefry2x32(
      keys.k[3 * g], keys.k[3 * g + 1], keys.k[3 * g + 2],
      static_cast<unsigned>(ctr >> 32), static_cast<unsigned>(ctr));
  const unsigned word = b.x ^ b.y;
  const unsigned row = i / n_words;
  const int j0 = static_cast<int>(i - row * n_words) * 4;
  unsigned char* dst = mask + g * plane_bytes +
                       static_cast<long long>(row) * last + j0;
  if (kAligned) {
    unsigned v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v |= static_cast<unsigned>(((word >> (8 * k)) & 0xFFu) < thresh)
           << (8 * k);
    }
    *reinterpret_cast<unsigned*>(dst) = v;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (j0 + k < last) dst[k] = ((word >> (8 * k)) & 0xFFu) < thresh;
    }
  }
}

// B = SMs x k blocks, k = the fewest resident blocks per SM that give
// each thread about one unit, at most the occupancy: every block is
// resident, as the grid barrier needs.
int launch_edges(EdgeArgs a, Keys keys, int device, cudaStream_t stream) {
  int coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_masks_kernel, ppnp::kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long units = static_cast<long long>(a.nnz) * a.n_words;
  const long long slots = static_cast<long long>(n_sm) * ppnp::kBlock;
  const long long k = (units + slots - 1) / slots;
  const int blocks = n_sm * static_cast<int>(k < per_sm ? k : per_sm);
  void* args[] = {&a, &keys};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(edge_masks_kernel), blocks, ppnp::kBlock,
      args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Keys copy_keys(const unsigned* keys, int n_keys) {
  Keys k{};
  for (int p = 0; p < n_keys; ++p) {
    k.k[3 * p] = keys[2 * p];
    k.k[3 * p + 1] = keys[2 * p + 1];
    k.k[3 * p + 2] = keys[2 * p] ^ keys[2 * p + 1] ^ 0x1BD11BDAu;
  }
  return k;
}

}  // namespace

// n_keys planes of A (and of A^T when val_t is given) in one cooperative
// launch on `stream`; returns a CUDA error code (0: the launch was
// accepted). `keys` is a host array of 2 * n_keys words, 1 <= n_keys <=
// 256. Two layouts: `pos` is A^T's fwd_pos and `bits` scratch of nnz *
// ceil(n_keys / 32) words. nnz >= 1.
extern "C" int ppnp_edge_masks(
    const int* rows, const int* col, const float* val, float* out, int nnz,
    int transposed, long long span, const int* pos, const float* val_t,
    float* out_t, unsigned* bits, const unsigned* keys,
    int n_keys, unsigned thresh, float keep, float scale, int device,
    void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || nnz < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_words = (n_keys + kWordPlanes - 1) / kWordPlanes;
  const EdgeArgs a{rows,   col,    val,    out,     nnz,
                   transposed, span, pos, val_t, out_t,
                   bits,   n_keys, n_words, (n_keys + n_words - 1) / n_words,
                   thresh, keep,   scale};
  return launch_edges(a, copy_keys(keys, n_keys), device,
                      static_cast<cudaStream_t>(stream));
}

// The (n_keys, n_rows, last) keep masks of dense dropout, as bytes 0/1,
// plane g from keys[2g], keys[2g + 1], in one launch on `stream`; returns
// a CUDA error code. 1 <= n_keys <= 256; n_rows * ceil(last / 4) words
// a plane, fewer than 2^32 - 256 (the thread index is 32-bit), counted
// from the flat word `word_offset` of each key's draw (0: the whole
// array; a row slice [lo, hi) of it: lo * ceil(last / 4)).
extern "C" int ppnp_dropout_masks(const unsigned* keys, int n_keys,
                                  long long n_rows, int last, unsigned thresh,
                                  long long word_offset, unsigned char* mask,
                                  int device, void* stream) {
  const long long n_words = (last + 3) / 4;
  const long long plane_words = n_rows * n_words;
  if (n_keys < 1 || n_keys > kMaxKeys || last < 1 || word_offset < 0 ||
      plane_words > 0xFFFFFF00ll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plane_words == 0) return 0;
  const dim3 grid(
      static_cast<unsigned>((plane_words + ppnp::kBlock - 1) / ppnp::kBlock),
      static_cast<unsigned>(n_keys));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Keys k = copy_keys(keys, n_keys);
  const unsigned pw = static_cast<unsigned>(plane_words);
  const unsigned long long off = static_cast<unsigned long long>(word_offset);
  if (last % 4 == 0) {
    dropout_masks_kernel<true><<<grid, ppnp::kBlock, 0, st>>>(
        k, pw, static_cast<int>(n_words), last, n_rows * last, thresh, off,
        mask);
  } else {
    dropout_masks_kernel<false><<<grid, ppnp::kBlock, 0, st>>>(
        k, pw, static_cast<int>(n_words), last, n_rows * last, thresh, off,
        mask);
  }
  return static_cast<int>(cudaGetLastError());
}
