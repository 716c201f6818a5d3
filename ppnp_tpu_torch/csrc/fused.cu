// K3: all K APPNP steps H_{k+1} = A_k H_k + alpha * H0 in ONE launch, on
// Hopper (sm_90a), in forward mode and in adjoint mode.
//
// Replaces the TPU kernel ppnp_tpu/kernels/fused.py:84 _fused_kernel
// (launched by appnp_fused, in both of its modes). On the TPU the grid ran
// in order on one core, so iteration k simply followed iteration k-1
// through VMEM. Here blocks run in parallel on 132 SMs, and a row of
// iteration k+1 may start once the rows it gathers from are stored.
//
// Bound on this card: bytes, as PERF.md's table counts them. The function
// must read row_ptr, col, the weight plane(s) and H0 once and write the
// output once: at MS Academic (206,015 edges, 18,331 rows, c = 15, K = 10)
// ~3.9 MB with one shared plane, 1.17 us at 3.35 TB/s; the adjoint with K
// planes ~11.3 MB, 3.38 us. Its ~62 MFLOP take ~1 us at 67 TFLOP/s f32.
// What the kernel really moves is K times the per-step gather, through L2:
// the K - 1 intermediate planes (~11 MB), the edges and the weights stay
// in the 50 MB L2. So the floor in practice is K dependent rounds of
// gathers from L2 and hand-overs between SMs, not bytes.
//
// Design:
// - Persistent, edge-balanced row bands. The launch is cooperative
//   (cudaLaunchCooperativeKernel): blocks wait for each other by spinning,
//   which is safe only when all of them are resident, and the launch is
//   refused when they cannot be. Blocks of 1,024 threads, two per SM (64
//   warps, at most 32 registers a thread); block b owns the contiguous
//   band of rows r with floor(b W / B) <= row_ptr[r] + r < floor((b + 1)
//   W / B), W = nnz + n, for all K iterations: each band holds about W / B
//   edges plus rows (an edgeless row still stores alpha * H0). A block
//   finds its band in its prologue by a 512-ary search on row_ptr for
//   each end (two rounds of loads at n < 2^18), so nothing is done on the
//   host, and copies its first kStage edges' columns, and their weights
//   where one plane serves every iteration, to shared memory.
// - A group of TPR lanes (half K1's: 8 at c = 15) owns a row, each lane
//   two columns, so that a block has a group for every row of its band
//   (at MS Academic 111 rows at most, 128 groups): no iteration has a
//   second, latency-bound pass over rows, as a grid-stride loop has.
// - Ready flags per band instead of a grid-wide barrier. After storing
//   its rows of iteration k a block does __syncthreads() and one thread
//   publishes flag[b] = k + 1 (fence.acq_rel.gpu, then a relaxed store:
//   the release pattern of CUTLASS's generic barrier). Before iteration
//   k + 1, warp 0 reads only the flags of the bands that its band's edges
//   gather from, [band_of(min col), band_of(max col)], found once in the
//   prologue: up to 8 relaxed loads a lane in flight at once, repeated
//   until one round sees them all, then one acquire fence; then
//   __syncthreads(). No wait ever gives up: the dependencies run from
//   iteration k + 1 to k only, so every flag is published in the end.
// - One buffer per iteration. Iteration k reads H_k (H0, or plane k - 1
//   of `tmp`) and writes plane k (the last iteration: `out`). A ping-pong
//   buffer would have a write-after-read hazard once blocks no longer
//   move in lockstep; with a buffer each, only read-after-write needs
//   ordering, and the flags give it. The planes' rows are padded to 8
//   floats (c = 15: 64 bytes, two 32-byte sectors, where a 60-byte row at
//   any 4-byte offset touches up to three). Reads of H_k and M_s bypass L1
//   (__ldcg): they were written by other SMs in this launch.
// - The flags live in a buffer of the wrapper's, one per device and
//   stream, zeroed once when it is made. The last block to finish a
//   launch (an atomic count of finished blocks) sets every word back to
//   0, so the next launch on the stream finds it zeroed: no memset launch
//   per call (the fused arm is host-bound), no counter to wrap, and a
//   replayed CUDA graph finds it zeroed too. Launches on one stream run in
//   order; another stream gets its own buffer.
//
// Forward mode: every element is acc = alpha * H0[i, j], then
// fmaf(w[e], H_k[col[e], j], acc) over the row's edges in CSR order, as
// K1 computes it (spmm.cu): the output is bit-equal to K queued K1
// launches with init = alpha * H0. The weight plane is plane 0 for every
// k (shared) or plane k.
//
// Adjoint mode (the train-mode VJP, run on the TRANSPOSE operator with the
// planes in reverse iteration order): M_0 = g, M_{s+1} = A_s M_s, and
// out = alpha * (M_0 + ... + M_{K-1}) + M_K. The output starts at
// alpha * g; iteration s computes a row of M_{s+1}, stores it in plane s
// of `tmp` (M_K is not stored) and adds alpha * M_{s+1}, or M_K at the
// last iteration, to the same row of the output as
// __fadd_rn(out, __fmul_rn(coef, m)): rounded twice, never contracted to
// an FMA, so it is bit-equal to K queued K1-backward launches on A^T
// accumulated in PyTorch as out = out + coef * m, the order of the TPU
// kernel (ppnp_tpu/kernels/fused.py:165-198, out_ref[:] += alpha * m). The
// lanes that own a row's columns own its output columns in every
// iteration, so the accumulation needs no ordering of its own.
//
// Measured on the H100 and rejected (PERF.md, Findings on K3): one warp
// polling the flags with acquire loads one after another; every thread
// polling, with a fence each; blocks of 256 or 512 threads at up to 8 per
// SM (more bands, so more flags to wait on: 500-800 at MS Academic); one
// block per SM with all of a band's gathers staged in shared memory by
// cp.async (with or without issuing each source band's as soon as its
// flag was up); a per-iteration plane's weights copied to shared memory
// by cp.async before each wait; lanes of 4 float4 columns or 16 single
// columns; unpadded planes.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPerSM = 2;  // blocks per SM: 64 warps, <= 32 registers
// Edges of a band whose columns and weights are staged in shared memory
// (32 KB).
constexpr int kStage = 4096;
// Words of `info` per block: start, end, lo, hi of its band; SM clock
// cycles of its prologue, of its waits and of the whole kernel.
constexpr int kInfo = 8;

// Row stride of the intermediate planes: c rounded up to 8 floats, so a
// row starts on a 32-byte sector.
__host__ __device__ constexpr int padded(int c) { return (c + 7) / 8 * 8; }

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n\tst.relaxed.gpu.global.s32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

// One step of a search for the least r in [lo, hi] with row_ptr[r] + r >=
// target, given how many of the probes lo, lo + step, ... (those below
// hi) fall short of it.
__device__ __forceinline__ void narrow(int& lo, int& hi, int step,
                                       int n_below) {
  if (n_below == 0) {
    hi = lo;
    return;
  }
  hi = min(lo + n_below * step, hi);
  lo += (n_below - 1) * step + 1;
}

// The least rows r0 and r1 in [0, n] with row_ptr[r] + r >= t0 and t1
// (r = n always qualifies): half the block searches for each, every
// thread probing one row per round (two rounds at n < 2^18).
__device__ int2 find_rows(const int* row_ptr, int n, long long t0,
                          long long t1) {
  constexpr int kHalf = kThreads / 2;
  int lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;
  const bool second = threadIdx.x >= kHalf;
  const int i = static_cast<int>(threadIdx.x) % kHalf;
  while (lo0 < hi0 || lo1 < hi1) {
    const int step0 = (hi0 - lo0 + kHalf - 1) / kHalf;
    const int step1 = (hi1 - lo1 + kHalf - 1) / kHalf;
    const int p = second ? lo1 + i * step1 : lo0 + i * step0;
    const bool below = p < (second ? hi1 : hi0) &&
                       static_cast<long long>(row_ptr[p]) + p <
                           (second ? t1 : t0);
    const int n0 = __syncthreads_count(below && !second);
    const int n1 = __syncthreads_count(below && second);
    narrow(lo0, hi0, step0, n0);
    narrow(lo1, hi1, step1, n1);
  }
  return make_int2(lo0, lo1);
}

// The band that holds row r: the largest b with floor(b * work / B) <=
// row_ptr[r] + r.
__device__ __forceinline__ int band_of(const int* row_ptr, long long work,
                                       int n_bands, int r) {
  return static_cast<int>(
      ((static_cast<long long>(row_ptr[r]) + r + 1) * n_bands - 1) / work);
}

struct Band {
  int start, end;     // rows [start, end)
  int lo, hi;         // the bands its edges gather from (lo > hi: none)
  int first, staged;  // its first edge; how many from there are staged
};

// Block b's band: the rows r with floor(b * work / B) <= row_ptr[r] + r <
// floor((b + 1) * work / B), work = nnz + n, and the range of bands it
// waits on, [band_of(min col), band_of(max col)]. Its first kStage edges'
// columns, and their weights where one plane (`w`) serves every
// iteration, are copied to shared memory. `info` (may be null) gets start, end, lo and
// hi; report() fills the rest.
__device__ Band find_band(const int* row_ptr, const int* col, const float* w,
                          bool stage_w, int n, int* s_col, float* s_w,
                          int* info) {
  __shared__ int s[2];
  const int b = blockIdx.x, n_bands = gridDim.x;
  const long long work = static_cast<long long>(row_ptr[n]) + n;
  const int2 rows =
      find_rows(row_ptr, n, b * work / n_bands, (b + 1) * work / n_bands);
  const int first = row_ptr[rows.x];
  const int n_edges = row_ptr[rows.y] - first;
  Band band{rows.x, rows.y, 1, 0, first, min(n_edges, kStage)};
  if (threadIdx.x == 0) s[0] = INT_MAX, s[1] = -1;
  __syncthreads();
  int mn = INT_MAX, mx = -1;
  for (int i = threadIdx.x; i < n_edges; i += kThreads) {
    const int j = col[first + i];
    mn = min(mn, j);
    mx = max(mx, j);
    if (i < kStage) {
      s_col[i] = j;
      if (stage_w) s_w[i] = w[first + i];
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (threadIdx.x % 32 == 0) {
    atomicMin(&s[0], mn);
    atomicMax(&s[1], mx);
  }
  __syncthreads();
  if (s[1] >= 0) {
    band.lo = band_of(row_ptr, work, n_bands, s[0]);
    band.hi = band_of(row_ptr, work, n_bands, s[1]);
  }
  if (info != nullptr && threadIdx.x == 0) {
    int* mine = info + kInfo * static_cast<size_t>(b);
    mine[0] = band.start, mine[1] = band.end, mine[2] = band.lo,
    mine[3] = band.hi;
  }
  return band;
}

// Where this block's clock cycles went (thread 0, when `info` is set).
__device__ __forceinline__ void report(int* info, long long t0,
                                       long long t_band, long long waited) {
  if (info == nullptr || threadIdx.x != 0) return;
  int* mine = info + kInfo * static_cast<size_t>(blockIdx.x);
  mine[4] = static_cast<int>(t_band - t0);
  mine[5] = static_cast<int>(waited);
  mine[6] = static_cast<int>(clock64() - t0);
}

// Iteration `done` of every band in [lo, hi] is stored and visible: warp
// 0 reads the flags until one round sees them all, then its acquire fence
// (one warp instruction); the other warps wait at the barrier. A round
// issues a lane's loads (relaxed, up to kPoll, lane-strided) before it
// compares any, so it costs one round trip to L2, not one per flag.
// Returns the clock cycles it took.
__device__ __forceinline__ long long wait_bands(const int* flags,
                                                const Band& band, int done) {
  constexpr int kPoll = 8;
  const long long t = clock64();
  if (threadIdx.x < 32) {
    // every lane runs every round: the rounds end on __all_sync
    for (int q0 = band.lo; q0 <= band.hi; q0 += 32 * kPoll) {
      bool ready;
      do {
        int v[kPoll];
#pragma unroll
        for (int r = 0; r < kPoll; ++r) {
          const int q = q0 + static_cast<int>(threadIdx.x) + 32 * r;
          v[r] = q <= band.hi ? load_relaxed(flags + q) : done;
        }
        ready = true;
#pragma unroll
        for (int r = 0; r < kPoll; ++r) ready &= v[r] >= done;
      } while (!__all_sync(0xffffffffu, ready));
    }
    fence_acq_rel();
  }
  __syncthreads();
  return clock64() - t;
}

// This block's rows of iteration `done` are stored.
__device__ __forceinline__ void publish(int* flags, int done) {
  __syncthreads();
  if (threadIdx.x == 0) store_release(flags + blockIdx.x, done);
}

// The last block to get here sets the sync words back to 0: every other
// block has finished, so no flag is read again in this launch.
__device__ void finish(int* sync) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(sync, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int i = threadIdx.x; i <= static_cast<int>(gridDim.x); i += kThreads)
    sync[i] = 0;
}

// acc[v] + sum over the row's edges, in CSR order, of w * src[col,
// j + v * TPR] for the live columns (v = 0, and v = 1 where `two`), one
// fmaf each: the chain K1 computes per element. src's rows are `stride`
// floats apart; `cols` and `ws` point at the row's first edge, in shared
// memory where the band's edges are staged, else in device memory; src
// may have been written in this launch: L2 only.
template <int TPR>
__device__ __forceinline__ void dot(const int* cols, const float* ws,
                                    int count, const float* src, int stride,
                                    int j, bool two, float (&acc)[2]) {
#pragma unroll 4
  for (int e = 0; e < count; ++e) {
    const float* p = src + static_cast<size_t>(cols[e]) * stride + j;
    const float we = ws[e];
    acc[0] = fmaf(we, __ldcg(p), acc[0]);
    if (two) acc[1] = fmaf(we, __ldcg(p + TPR), acc[1]);
  }
}

// Iteration k's source: H0 (or g) of row stride c, then the padded plane
// k - 1; and its weight plane.
struct Source {
  const float* h;
  int stride;
  const float* w;
};

__device__ __forceinline__ Source source_of(int k, const float* h0,
                                            const float* tmp, int n, int c,
                                            const float* e_w_all,
                                            int n_planes, int nnz) {
  const float* w =
      e_w_all + static_cast<size_t>(n_planes == 1 ? 0 : k) * nnz;
  if (k == 0) return {h0, c, w};
  return {tmp + static_cast<size_t>(k - 1) * n * padded(c), padded(c), w};
}

// acc + row `row`'s sums for columns j and j + TPR (staged_w: one plane
// serves every iteration, and its staged weights are in shared memory).
template <int TPR>
__device__ __forceinline__ void row_dot(const Band& band, const int* s_col,
                                        const float* s_w, bool staged_w,
                                        const int* row_ptr, const int* col,
                                        const Source& s, int row, int j,
                                        bool two, float (&acc)[2]) {
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  const int at = beg - band.first;
  if (end - band.first <= band.staged) {
    dot<TPR>(s_col + at, staged_w ? s_w + at : s.w + beg, end - beg, s.h,
             s.stride, j, two, acc);
  } else {
    dot<TPR>(col + beg, s.w + beg, end - beg, s.h, s.stride, j, two, acc);
  }
}

// A group of TPR lanes owns a row, lane l its columns l and l + TPR of
// each pass over the row's edges (2 TPR columns a pass).
template <int TPR>
__global__ void __launch_bounds__(kThreads, kPerSM)
appnp_fused_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col,
                   const float* __restrict__ e_w_all, int n_planes, int nnz,
                   const float* __restrict__ h0, float* out, float* tmp,
                   int n, int c, float alpha, int niter, int* sync,
                   int* info) {
  constexpr int kGroups = kThreads / TPR;
  __shared__ int s_col[kStage];
  __shared__ float s_w[kStage];
  const long long t0 = clock64();
  const bool shared_w = n_planes == 1;
  const Band band = find_band(row_ptr, col, e_w_all, shared_w, n, s_col, s_w,
                              info);
  const long long t_band = clock64();
  long long waited = 0;
  const int group = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int cs = padded(c);
  int* flags = sync + 1;
  for (int k = 0; k < niter; ++k) {
    const Source s = source_of(k, h0, tmp, n, c, e_w_all, n_planes, nnz);
    if (k > 0) waited += wait_bands(flags, band, k);
    const bool last = k + 1 == niter;
    float* dst = last ? out : tmp + static_cast<size_t>(k) * n * cs;
    const int dst_stride = last ? c : cs;
    for (int row = band.start + group; row < band.end; row += kGroups) {
      const float* h0_row = h0 + static_cast<size_t>(row) * c;
      float* dst_row = dst + static_cast<size_t>(row) * dst_stride;
      for (int j = lane; j < c; j += 2 * TPR) {
        const bool two = j + TPR < c;
        float acc[2] = {__fmul_rn(alpha, h0_row[j]),
                        two ? __fmul_rn(alpha, h0_row[j + TPR]) : 0.0f};
        row_dot<TPR>(band, s_col, s_w, shared_w, row_ptr, col, s, row, j,
                     two, acc);
        dst_row[j] = acc[0];
        if (two) dst_row[j + TPR] = acc[1];
      }
    }
    if (!last) publish(flags, k + 1);
  }
  report(info, t0, t_band, waited);
  if (niter > 1) finish(sync);
}

template <int TPR>
__global__ void __launch_bounds__(kThreads, kPerSM)
appnp_adjoint_kernel(const int* __restrict__ row_ptr,
                     const int* __restrict__ col,
                     const float* __restrict__ e_w_all, int n_planes,
                     int nnz, const float* __restrict__ g, float* out,
                     float* tmp, int n, int c, float alpha, int niter,
                     int* sync, int* info) {
  constexpr int kGroups = kThreads / TPR;
  __shared__ int s_col[kStage];
  __shared__ float s_w[kStage];
  const long long t0 = clock64();
  const bool shared_w = n_planes == 1;
  const Band band = find_band(row_ptr, col, e_w_all, shared_w, n, s_col, s_w,
                              info);
  const long long t_band = clock64();
  long long waited = 0;
  const int group = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const int cs = padded(c);
  int* flags = sync + 1;
  for (int s = 0; s < niter; ++s) {
    const Source src = source_of(s, g, tmp, n, c, e_w_all, n_planes, nnz);
    if (s > 0) waited += wait_bands(flags, band, s);
    const bool last = s + 1 == niter;
    const float coef = last ? 1.0f : alpha;
    float* dst = tmp + static_cast<size_t>(s) * n * cs;
    for (int row = band.start + group; row < band.end; row += kGroups) {
      float* out_row = out + static_cast<size_t>(row) * c;
      const float* g_row = g + static_cast<size_t>(row) * c;
      float* dst_row = dst + static_cast<size_t>(row) * cs;
      for (int j = lane; j < c; j += 2 * TPR) {
        const bool two = j + TPR < c;
        // the output so far (alpha * g before the first iteration), read
        // before the walk so that its load overlaps the gathers
        float o[2];
        for (int v = 0; v < 2; ++v) {
          const int jv = j + v * TPR;
          if (v == 1 && !two) break;
          o[v] = s == 0 ? __fmul_rn(alpha, g_row[jv]) : out_row[jv];
        }
        float m[2] = {0.0f, 0.0f};
        row_dot<TPR>(band, s_col, s_w, shared_w, row_ptr, col, src, row, j,
                     two, m);
        for (int v = 0; v < 2; ++v) {
          const int jv = j + v * TPR;
          if (v == 1 && !two) break;
          if (!last) dst_row[jv] = m[v];
          out_row[jv] = __fadd_rn(o[v], __fmul_rn(coef, m[v]));
        }
      }
    }
    if (!last) publish(flags, s + 1);
  }
  report(info, t0, t_band, waited);
  if (niter > 1) finish(sync);
}

// B = (resident blocks per SM) x (SMs): every block resident, one band
// each.
template <typename Kernel>
int launch(Kernel kernel, const int* row_ptr, const int* col,
           const float* e_w_all, int n_planes, int nnz, const float* h0,
           float* out, float* tmp, int n, int c, float alpha, int niter,
           int* sync, int sync_words, int* info, int device,
           cudaStream_t stream) {
  int coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = per_sm * n_sm;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (blocks + 1 > sync_words) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&row_ptr, &col, &e_w_all, &n_planes, &nnz, &h0,   &out,
                  &tmp,     &n,   &c,       &alpha,    &niter, &sync, &info};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    blocks, kThreads, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool adjoint, const int* row_ptr, const int* col,
             const float* e_w_all, int n_planes, int nnz, const float* h0,
             float* out, float* tmp, int n, int c, float alpha, int niter,
             int* sync, int sync_words, int* info, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PPNP_LAUNCH(TPR)                                                      \
  return adjoint                                                              \
             ? launch(appnp_adjoint_kernel<TPR>, row_ptr, col, e_w_all,       \
                      n_planes, nnz, h0, out, tmp, n, c, alpha, niter, sync,  \
                      sync_words, info, device, st)                           \
             : launch(appnp_fused_kernel<TPR>, row_ptr, col, e_w_all,         \
                      n_planes, nnz, h0, out, tmp, n, c, alpha, niter, sync,  \
                      sync_words, info, device, st)
  // lanes per row: half of K1's (two columns a lane), so that a block
  // has a group for every row of its band
  switch (ppnp::threads_per_row(c)) {
    case 8:
      PPNP_LAUNCH(4);
    case 16:
      PPNP_LAUNCH(8);
    default:
      PPNP_LAUNCH(16);
  }
#undef PPNP_LAUNCH
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code; 0 means the cooperative launch was accepted. `e_w_all` holds
// n_planes (1 or niter) planes of nnz weights with (1 - alpha) already
// applied; `tmp` is scratch of niter - 1 planes of n rows of c rounded up
// to 8 floats (unused for niter = 1). `sync` is `sync_words` int32 words,
// zero before the launch and zero again after it; it needs one word more
// than the blocks launched. `info` (may be null) receives 8 words a block:
// start, end, lo, hi of its band, then the SM clock cycles of its
// prologue, of its waits and of the whole kernel.
extern "C" int ppnp_appnp_fused(const int* row_ptr, const int* col,
                                const float* e_w_all, int n_planes, int nnz,
                                const float* h0, float* out, float* tmp,
                                int n, int c, float alpha, int niter,
                                int* sync, int sync_words, int* info,
                                int device, void* stream) {
  return dispatch(false, row_ptr, col, e_w_all, n_planes, nnz, h0, out, tmp,
                  n, c, alpha, niter, sync, sync_words, info, device,
                  stream);
}

// Adjoint mode: `row_ptr`/`col` are the TRANSPOSE operator's, `g` the
// output cotangent, `e_w_all` the transpose-layout planes in reverse
// iteration order; the other arguments as above.
extern "C" int ppnp_appnp_adjoint(const int* row_ptr, const int* col,
                                  const float* e_w_all, int n_planes,
                                  int nnz, const float* g, float* out,
                                  float* tmp, int n, int c, float alpha,
                                  int niter, int* sync, int sync_words,
                                  int* info, int device, void* stream) {
  return dispatch(true, row_ptr, col, e_w_all, n_planes, nnz, g, out, tmp,
                  n, c, alpha, niter, sync, sync_words, info, device,
                  stream);
}
