// K1: out = A_w @ H (+ init) for a CSR matrix A, on Hopper (sm_90a).
//
// Replaces the TPU kernel ppnp_tpu/kernels/spmm.py::_spmm_kernel (launched
// by spmm_pair_chunks, and by its VJP _spmm_vjp_bwd on the transpose
// packing). On the TPU the kernel turned gather and scatter into one-hot
// MXU matmuls over the PairChunks packing; here a thread group gathers H's
// rows directly from CSR, so no packing is needed, and the backward
// dH = A_w^T g is this same kernel on the CSR of A^T with the same masked
// weights in A^T's order.
//
// Bound on this card: bytes. Per call the kernel must read row_ptr, col
// and w (4 + 8 B per edge), H once and init once, and write out once, and
// it does 2 flops per edge and column: at MS Academic (206,015 edges,
// 18,331 rows, c = 15) that is ~5 MB, about 1.5 us at 3.35 TB/s, against
// ~6 MFLOP, about 0.1 us of the 67 TFLOP/s f32 rate. So launch latency
// (a few us) dominates one call.
//
// Design: one group of TPR threads per output row (TPR = 8, 16 or 32 from
// c), lanes over the feature columns, so neighbouring threads read
// neighbouring floats of a gathered H row. Each element starts from init
// (or 0: rows without edges still produce init, as the TPU kernel seeds
// its accumulator) and adds its edges in CSR order, so the result is
// deterministic and needs no atomics. The whole ~5 MB working set sits in
// the 50 MB L2 across the ten calls of one request. wgmma and TMA do not
// apply to a gather of 60-byte rows; fewer launches (K3) is the lever.
//
// K2: out[:, g*cg + j] = init[:, g*cg + j] + sum_e w_g[g, e] * H[col[e], g*cg + j]
// for G weight planes over ONE sparse pattern (grouped_spmm_csr_kernel).
//
// Replaces the TPU kernel ppnp_tpu/kernels/spmm.py::_spmm_kernel_grouped
// (spmm_pair_chunks_grouped, and its VJP _spmm_vjp_grouped on the
// transpose packing): G seeds' features stacked along the lanes of H,
// each seed with its own edge-dropout plane. On the TPU one unweighted
// gather dot served all G groups and the planes applied as per-group VPU
// multiplies; that trick is about MXU issue slots and does not carry over.
//
// Bound on this card: bytes. At MS Academic, G = 10, the propagation step
// (cg = 15, 150 lanes, with init) must read col (0.8 MB), the ten planes
// (8.2 MB), H and init and write out (3 x 11.0 MB): ~42 MB, ~12.6 us at
// 3.35 TB/s; the sparse fc1 (X, cg = 64, 640 lanes) and its backward on
// X^T ~71 MB each, ~21 us. Its ~2 flops per edge and lane are ~1 % of
// that at the 67 TFLOP/s f32 rate.
//
// Design: K1's, over all G*cg lanes. One group of TPR threads per output
// row (32 here), lanes striding over the G*cg columns; column j belongs to
// group g = j / cg and reads plane g (w_g[g * nnz + e]). Each element
// starts from init (or 0) and adds its edges in CSR order with fmaf, so
// every output column is bit-equal to a K1 launch on that group's slice
// with that group's plane, as the TPU kernel is bit-equal to G K1 calls
// (spmm.py:140-142). The lever over G K1 launches: one launch gathers each
// H row (and reads col) once for all G groups, where G launches would
// gather it G times. Reading the planes per lane group is uncoalesced
// across groups; a coalesced (nnz, G) layout is later work.
#include "common.cuh"

namespace {

template <int TPR>
__global__ void __launch_bounds__(ppnp::kBlock)
spmm_csr_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ init, float* __restrict__ out,
                int n_rows, int c) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int row = static_cast<int>(t / TPR);
  const int lane = static_cast<int>(t % TPR);
  if (row >= n_rows) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const size_t base = static_cast<size_t>(row) * c;
  for (int j = lane; j < c; j += TPR) {
    const float acc = init != nullptr ? init[base + j] : 0.0f;
    out[base + j] = ppnp::row_dot<false>(col, w, h, beg, end, c, j, acc);
  }
}

template <int TPR>
void launch(const int* row_ptr, const int* col, const float* w,
            const float* h, const float* init, float* out, int n_rows, int c,
            cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows) * TPR;
  const unsigned blocks =
      static_cast<unsigned>((threads + ppnp::kBlock - 1) / ppnp::kBlock);
  spmm_csr_kernel<TPR><<<blocks, ppnp::kBlock, 0, stream>>>(
      row_ptr, col, w, h, init, out, n_rows, c);
}

template <int TPR>
__global__ void __launch_bounds__(ppnp::kBlock)
grouped_spmm_csr_kernel(const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ w_g,
                        const float* __restrict__ h,
                        const float* __restrict__ init,
                        float* __restrict__ out, int n_rows, int cg, int c,
                        int nnz) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int row = static_cast<int>(t / TPR);
  const int lane = static_cast<int>(t % TPR);
  if (row >= n_rows) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const size_t base = static_cast<size_t>(row) * c;
  for (int j = lane; j < c; j += TPR) {
    const float* w = w_g + static_cast<size_t>(j / cg) * nnz;
    const float acc = init != nullptr ? init[base + j] : 0.0f;
    out[base + j] = ppnp::row_dot<false>(col, w, h, beg, end, c, j, acc);
  }
}

template <int TPR>
void launch_grouped(const int* row_ptr, const int* col, const float* w_g,
                    const float* h, const float* init, float* out,
                    int n_rows, int cg, int c, int nnz, cudaStream_t stream) {
  const long long threads = static_cast<long long>(n_rows) * TPR;
  const unsigned blocks =
      static_cast<unsigned>((threads + ppnp::kBlock - 1) / ppnp::kBlock);
  grouped_spmm_csr_kernel<TPR><<<blocks, ppnp::kBlock, 0, stream>>>(
      row_ptr, col, w_g, h, init, out, n_rows, cg, c, nnz);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); 0 means the launch was accepted. `init` may be null.
extern "C" int ppnp_spmm_csr(const int* row_ptr, const int* col,
                             const float* w, const float* h,
                             const float* init, float* out, int n_rows, int c,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppnp::threads_per_row(c)) {
    case 8:
      launch<8>(row_ptr, col, w, h, init, out, n_rows, c, s);
      break;
    case 16:
      launch<16>(row_ptr, col, w, h, init, out, n_rows, c, s);
      break;
    default:
      launch<32>(row_ptr, col, w, h, init, out, n_rows, c, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 on `stream`: G = `groups` planes w_g (groups x nnz, CSR order) over
// one pattern, H and out of groups * cg columns; returns
// cudaGetLastError(). `init` may be null.
extern "C" int ppnp_grouped_spmm_csr(const int* row_ptr, const int* col,
                                     const float* w_g, const float* h,
                                     const float* init, float* out,
                                     int n_rows, int groups, int cg, int nnz,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = groups * cg;
  switch (ppnp::threads_per_row(c)) {
    case 8:
      launch_grouped<8>(row_ptr, col, w_g, h, init, out, n_rows, cg, c, nnz,
                        s);
      break;
    case 16:
      launch_grouped<16>(row_ptr, col, w_g, h, init, out, n_rows, cg, c,
                         nnz, s);
      break;
    default:
      launch_grouped<32>(row_ptr, col, w_g, h, init, out, n_rows, cg, c,
                         nnz, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
