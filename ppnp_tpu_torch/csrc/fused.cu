// K3: all K APPNP steps H_{k+1} = A_k H_k + alpha * H0 in ONE launch, on
// Hopper (sm_90a), in forward mode and in adjoint mode.
//
// Replaces the TPU kernel ppnp_tpu/kernels/fused.py::_fused_kernel
// (launched by appnp_fused, in both of its modes). On the TPU the grid ran
// in order on one core, so iteration k simply followed iteration k-1
// through VMEM. Here blocks run in parallel on 132 SMs, so the iterations
// are separated by a grid-wide barrier: the kernel is launched
// cooperatively (cudaLaunchCooperativeKernel, every block co-resident) and
// calls cooperative_groups::this_grid().sync() between iterations.
//
// Bound on this card: bytes. The function must read row_ptr, col, the
// weight plane(s) and H0 once and write the output once: at MS Academic
// (206,015 edges, 18,331 rows, c = 15, K = 10, one shared plane) about
// 3 MB, ~1 us at 3.35 TB/s; its ~62 MFLOP take ~1 us at 67 TFLOP/s f32.
// With K per-iteration planes (training) the planes dominate: ~8 MB.
// What the kernel really moves is K times the per-step gather, but it
// moves it through L2: H ping-pongs between two device buffers whose
// ~2.2 MB, with the edges, stay in the 50 MB L2 for all K iterations.
//
// Design: as K1 (common.cuh), a group of TPR threads per row, lanes over
// columns, edges summed in CSR order; rows are covered by a grid-stride
// loop because the grid is capped at what can be co-resident (occupancy x
// SM count). A row belongs to the same thread group in every iteration.
//
// Forward mode: iteration k writes `out` when K-1-k is even and `tmp`
// otherwise, and reads the other one (H0 at k = 0), so the last iteration
// writes `out`. Each row is seeded with alpha * H0 (the fused alpha-mix).
// The weight plane is plane 0 for every k (shared) or plane k.
//
// Adjoint mode (the train-mode VJP, run on the TRANSPOSE operator with the
// planes in reverse iteration order): M_0 = g, M_{s+1} = A_s M_s, and
// out = alpha * (M_0 + ... + M_{K-1}) + M_K. The output starts at
// alpha * g; iteration s computes a row of M_{s+1}, stores it for the next
// iteration (M ping-pongs between the two halves of `tmp`; M_K is not
// stored) and adds alpha * M_{s+1}, or M_K at the last iteration, to the
// same row of the output. The thread that owns a row owns its output row
// in every iteration, so the accumulation needs no barrier of its own and
// its order is that of the TPU kernel.
//
// Reads of H_k and M_s bypass L1 (they were written by other SMs in this
// launch).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

template <int TPR>
__global__ void __launch_bounds__(ppnp::kBlock)
appnp_fused_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col,
                   const float* __restrict__ e_w_all, int n_planes, int nnz,
                   const float* __restrict__ h0, float* out, float* tmp,
                   int n, int c, float alpha, int niter) {
  cg::grid_group grid = cg::this_grid();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int group = static_cast<int>(t / TPR);
  const int lane = static_cast<int>(t % TPR);
  const int n_groups =
      static_cast<int>(static_cast<long long>(gridDim.x) * blockDim.x / TPR);
  for (int k = 0; k < niter; ++k) {
    const float* src = k == 0 ? h0 : ((niter - k) % 2 == 0 ? out : tmp);
    float* dst = (niter - 1 - k) % 2 == 0 ? out : tmp;
    const float* w =
        e_w_all + static_cast<size_t>(n_planes == 1 ? 0 : k) * nnz;
    for (int row = group; row < n; row += n_groups) {
      const int beg = row_ptr[row];
      const int end = row_ptr[row + 1];
      const size_t base = static_cast<size_t>(row) * c;
      for (int j = lane; j < c; j += TPR) {
        const float acc = alpha * h0[base + j];
        dst[base + j] = ppnp::row_dot<true>(col, w, src, beg, end, c, j, acc);
      }
    }
    if (k + 1 < niter) grid.sync();
  }
}

template <int TPR>
__global__ void __launch_bounds__(ppnp::kBlock)
appnp_adjoint_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col,
                     const float* __restrict__ e_w_all, int n_planes, int nnz,
                     const float* __restrict__ g, float* out, float* tmp,
                     int n, int c, float alpha, int niter) {
  cg::grid_group grid = cg::this_grid();
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int group = static_cast<int>(t / TPR);
  const int lane = static_cast<int>(t % TPR);
  const int n_groups =
      static_cast<int>(static_cast<long long>(gridDim.x) * blockDim.x / TPR);
  const size_t plane = static_cast<size_t>(n) * c;
  for (int row = group; row < n; row += n_groups) {
    const size_t base = static_cast<size_t>(row) * c;
    for (int j = lane; j < c; j += TPR) out[base + j] = alpha * g[base + j];
  }
  for (int s = 0; s < niter; ++s) {
    const float* src = s == 0 ? g : tmp + ((s - 1) % 2) * plane;
    float* dst = tmp + (s % 2) * plane;
    const bool last = s + 1 == niter;
    const float coef = last ? 1.0f : alpha;
    const float* w =
        e_w_all + static_cast<size_t>(n_planes == 1 ? 0 : s) * nnz;
    for (int row = group; row < n; row += n_groups) {
      const int beg = row_ptr[row];
      const int end = row_ptr[row + 1];
      const size_t base = static_cast<size_t>(row) * c;
      for (int j = lane; j < c; j += TPR) {
        const float m = ppnp::row_dot<true>(col, w, src, beg, end, c, j, 0.0f);
        if (!last) dst[base + j] = m;
        out[base + j] += coef * m;
      }
    }
    if (!last) grid.sync();
  }
}

template <typename Kernel>
int coop_launch(Kernel kernel, int tpr, const int* row_ptr, const int* col,
                const float* e_w_all, int n_planes, int nnz, const float* h0,
                float* out, float* tmp, int n, int c, float alpha, int niter,
                int device, cudaStream_t stream) {
  int coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      ppnp::kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need =
      (static_cast<long long>(n) * tpr + ppnp::kBlock - 1) / ppnp::kBlock;
  const long long cap = static_cast<long long>(per_sm) * n_sm;
  const unsigned blocks =
      static_cast<unsigned>(need < 1 ? 1 : (need < cap ? need : cap));
  void* args[] = {&row_ptr, &col, &e_w_all, &n_planes, &nnz, &h0, &out,
                  &tmp,     &n,   &c,       &alpha,    &niter};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    blocks, ppnp::kBlock, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int TPR>
int launch(bool adjoint, const int* row_ptr, const int* col,
           const float* e_w_all, int n_planes, int nnz, const float* h0,
           float* out, float* tmp, int n, int c, float alpha, int niter,
           int device, cudaStream_t stream) {
  if (adjoint) {
    return coop_launch(appnp_adjoint_kernel<TPR>, TPR, row_ptr, col, e_w_all,
                       n_planes, nnz, h0, out, tmp, n, c, alpha, niter,
                       device, stream);
  }
  return coop_launch(appnp_fused_kernel<TPR>, TPR, row_ptr, col, e_w_all,
                     n_planes, nnz, h0, out, tmp, n, c, alpha, niter, device,
                     stream);
}

int dispatch(bool adjoint, const int* row_ptr, const int* col,
             const float* e_w_all, int n_planes, int nnz, const float* h0,
             float* out, float* tmp, int n, int c, float alpha, int niter,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ppnp::threads_per_row(c)) {
    case 8:
      return launch<8>(adjoint, row_ptr, col, e_w_all, n_planes, nnz, h0, out,
                       tmp, n, c, alpha, niter, device, s);
    case 16:
      return launch<16>(adjoint, row_ptr, col, e_w_all, n_planes, nnz, h0,
                        out, tmp, n, c, alpha, niter, device, s);
    default:
      return launch<32>(adjoint, row_ptr, col, e_w_all, n_planes, nnz, h0,
                        out, tmp, n, c, alpha, niter, device, s);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code; 0 means the cooperative launch was accepted. `tmp` is scratch of
// the output's shape; `e_w_all` holds n_planes (1 or niter) planes of nnz
// weights with (1 - alpha) already applied.
extern "C" int ppnp_appnp_fused(const int* row_ptr, const int* col,
                                const float* e_w_all, int n_planes, int nnz,
                                const float* h0, float* out, float* tmp,
                                int n, int c, float alpha, int niter,
                                int device, void* stream) {
  return dispatch(false, row_ptr, col, e_w_all, n_planes, nnz, h0, out, tmp,
                  n, c, alpha, niter, device, stream);
}

// Adjoint mode: `row_ptr`/`col` are the TRANSPOSE operator's, `g` the
// output cotangent, `e_w_all` the transpose-layout planes in reverse
// iteration order; `tmp` is scratch of two output shapes (one suffices
// for niter <= 2). Returns a CUDA error code as above.
extern "C" int ppnp_appnp_adjoint(const int* row_ptr, const int* col,
                                  const float* e_w_all, int n_planes, int nnz,
                                  const float* g, float* out, float* tmp,
                                  int n, int c, float alpha, int niter,
                                  int device, void* stream) {
  return dispatch(true, row_ptr, col, e_w_all, n_planes, nnz, g, out, tmp, n,
                  c, alpha, niter, device, stream);
}
