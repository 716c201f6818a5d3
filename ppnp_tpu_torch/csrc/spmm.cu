// K1 and K2: CSR SpMM on Hopper (sm_90a). One kernel serves both.
//
// K1: out = A_w @ H (+ init) for a CSR matrix A whose edge weights w may
// be overridden per call. Replaces the TPU kernel
// ppnp_tpu/kernels/spmm.py::_spmm_kernel (launched by spmm_pair_chunks,
// and by its VJP _spmm_vjp_bwd on the transpose packing). On the TPU the
// kernel turned gather and scatter into one-hot MXU matmuls over the
// PairChunks packing; here a thread group gathers H's rows directly from
// CSR, and the backward dH = A_w^T g is this same kernel on the CSR of A^T
// with the same masked weights in A^T's order.
//
// K2: out[:, g*cg + j] = init[:, g*cg + j] + sum_e w_g[g, e] * H[col[e], g*cg + j]
// for G weight planes (G x nnz, CSR order) over ONE sparse pattern.
// Replaces ppnp_tpu/kernels/spmm.py::_spmm_kernel_grouped
// (spmm_pair_chunks_grouped, and its VJP _spmm_vjp_grouped on the
// transpose packing): G seeds' features stacked along the lanes of H, each
// seed with its own edge-dropout plane. K1 is K2 with G = 1 and cg = c.
//
// The invariant: each output element is acc = init[i, j] (or 0), then
// acc = fmaf(w[e], H[col[e], j], acc) for e in CSR order of row i. So the
// result is deterministic (no atomics), each K2 column is bit-equal to a
// K1 launch on its group's slice with its plane, and no launch shape
// changes an element's bits.
//
// Bound on this card: bytes. Per call the kernel must read row_ptr, col
// and the G planes, H once and init once, and write out once; it does 2
// flops per edge and column, ~1 % of the byte time at the 67 TFLOP/s f32
// rate. At MS Academic: K1 at the propagation step (206,015 edges, 18,331
// rows, c = 15) ~5 MB, 1.5 us at 3.35 TB/s; K2 at G = 10 (150 lanes, with
// init) ~42 MB, 12.6 us, and at G = 100 (1,500 lanes) ~413 MB, 123 us;
// the sparse fc1 on X and its backward on X^T (640 lanes) ~71 MB, 21 us.
// The gather reads one H row slice per edge from L2 (~124 MB at the K2
// step at G = 10, 1.24 GB at G = 100, ~375 MB at fc1), and L1 serves
// little of it:
// even 512 consecutive rows of the RCM-ordered operators gather 75 %
// distinct rows. So the floor in practice is the L2-to-SM rate.
//
// Design:
// - A group of L lanes (8, 16 or 32: the fewest that cover the row's
//   vector slots, so c = 15 packs two rows into a warp) owns one row and
//   one column tile of L * VEC * V columns. Each lane keeps V register
//   accumulators of VEC floats (float4 / float2 loads where the widths
//   and the pointers allow; V * VEC <= 8).
// - A slot need not lie in one group. Where a row takes several passes
//   (c > 256) and VEC divides c but not cg (cg = 15 at G = 100: 1,500
//   lanes), a slot runs from its first group into the next (cg >= VEC, so
//   never further). Its lane then loads both groups' plane words per edge
//   and gives each column its own group's; the gather stays one float4 /
//   float2. Each column still runs its own fmaf chain with its group's
//   weights, so straddling changes no bit. Straddling launches are their
//   own instantiation (STRADDLE), so K1 and the launches whose VEC divides
//   cg run the code they ran before. Taking the next group's word from
//   lane + 1 by a shuffle measured no faster.
// - Edges outer, columns inner: one pass over a row's edges per tile,
//   where a lane that strides over the columns walks the row once per
//   column it owns (5 walks at 150 lanes, 20 at 640). The loop body is unrolled
//   over D edges, so their gathers are in flight before their fmaf chains.
//   col and the planes are read per edge through L1: every lane of a
//   group reads the same word, one request for the group. Staging a row's
//   edges in shared memory or registers (shuffles) measured slower on the
//   H100: the latency and registers it costs exceed the L1 hits it saves.
// - Rows wider than one warp tile (640 lanes: 160 float4 slots) are cut
//   into column tiles of one slot per lane, a 2-D grid of (rows, tiles):
//   more, lighter warps beat deeper register tiles. With many rows (X:
//   18,331) the tiles are 8 lanes wide, with few (X^T: 6,805) 32;
//   straddling tiles are 32 lanes wide (the sweep's A_hat: 18,331 rows).
// - Output is written with streaming stores: out is not read again in the
//   launch, and evicting it first keeps H's rows in L2.
// - One column per lane (VEC = V = 1, as K1 at c = 15) is the per-lane
//   walk ppnp::row_dot: there it already is one pass, and it measured
//   fastest.
// - Not used: wgmma / tensor cores (an f32 gather at ~2 flops per gathered
//   float with a bit-exact order has no matrix tile to multiply) and TMA
//   (Hopper's tile copies cannot gather rows by index).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxFloats = 8;  // register floats per lane and edge
// Operators with at least this many rows cut wide rows into 8-lane tiles.
constexpr int kManyRows = 1 << 14;

// Edges per unrolled loop body: about 10 floats per lane in flight, at
// most 4 edges (measured: 4 edges at c = 64, 2 at the K2 step).
template <int VEC, int V>
__host__ __device__ constexpr int depth() {
  return 10 / (V * VEC) < 1 ? 1 : (10 / (V * VEC) > 4 ? 4 : 10 / (V * VEC));
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    __stcs(p, x[0]);
  }
}

// Grid: x over blocks of kBlock / L rows, y over column tiles. STRADDLE:
// a slot may run past its group's last column into the next group.
template <int L, int VEC, int V, bool STRADDLE>
__global__ void __launch_bounds__(ppnp::kBlock)
spmm_rows_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                 const float* __restrict__ w_g, const float* __restrict__ h,
                 const float* __restrict__ init, float* __restrict__ out,
                 int n_rows, int c, int cg, int nnz) {
  constexpr int D = depth<VEC, V>();
  constexpr int kStep = L * VEC;  // columns between a lane's slots
  const int lane = threadIdx.x % L;
  const int row = blockIdx.x * (ppnp::kBlock / L) + threadIdx.x / L;
  if (row >= n_rows) return;
  const int j0 = blockIdx.y * (kStep * V) + lane * VEC;  // first slot
  const size_t base = static_cast<size_t>(row) * c;

  if constexpr (V == 1 && VEC == 1) {  // one column per lane
    if (j0 >= c) return;
    const float* w =
        cg >= c ? w_g : w_g + static_cast<size_t>(j0 / cg) * nnz;
    const float acc = init != nullptr ? init[base + j0] : 0.0f;
    __stcs(out + base + j0, ppnp::row_dot(col, w, h, row_ptr[row],
                                          row_ptr[row + 1], c, j0, acc));
    return;
  }

  // A slot's first column j lies in group g = j / cg, whose plane is
  // w_g + g * nnz (a slot past c reads plane 0 and is not used). Its
  // first split[v] columns belong to g; with STRADDLE the rest, if any,
  // to g + 1, whose plane follows nnz words later. Without it VEC divides
  // cg and split[v] == VEC. K1 (cg == c) has one plane and no division.
  const float* w_slot[V];
  int split[V];
  bool live[V];
  float acc[V][VEC];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    live[v] = j0 + v * kStep < c;
    w_slot[v] = w_g;
    split[v] = VEC;
    if (live[v] && init != nullptr) {
      load_vec<VEC>(init + base + j0 + v * kStep, acc[v]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[v][q] = 0.0f;
    }
  }
  bool one_plane = true;  // this lane's slots start in one group
  if (cg < c) {
    int g = j0 / cg;
    int r = j0 - g * cg;
    const int step_g = kStep / cg;
    const int step_r = kStep - step_g * cg;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (live[v]) {
        w_slot[v] = w_g + static_cast<size_t>(g) * nnz;
        if constexpr (STRADDLE) split[v] = min(cg - r, VEC);
      }
      one_plane = one_plane && w_slot[v] == w_slot[0];
      g += step_g;
      r += step_r;
      if (r >= cg) r -= cg, ++g;
    }
  }

  // Edges outer, columns inner: one pass over the row.
  const float* h_lane = h + j0;
  const int end = row_ptr[row + 1];
#pragma unroll (D)
  for (int e = row_ptr[row]; e < end; ++e) {
    const float* src = h_lane + static_cast<size_t>(__ldg(col + e)) * c;
    const float w0 = __ldg(w_slot[0] + e);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float wt = one_plane || v == 0 ? w0 : __ldg(w_slot[v] + e);
      if (live[v]) {
        float x[VEC];
        load_vec<VEC>(src + v * kStep, x);
        if constexpr (STRADDLE) {
          const float wn = split[v] < VEC ? __ldg(w_slot[v] + nnz + e) : wt;
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[v][q] = fmaf(q < split[v] ? wt : wn, x[q], acc[v][q]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[v][q] = fmaf(wt, x[q], acc[v][q]);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (live[v]) store_vec<VEC>(out + base + j0 + v * kStep, acc[v]);
  }
}

struct Shape {
  int lanes, vec, v, tiles;
  bool straddle;  // VEC does not divide cg: slots straddle two groups
};

bool aligned(const void* p, int vec) {
  return reinterpret_cast<std::uintptr_t>(p) % (4 * vec) == 0;
}

// VEC: the widest of float4 / float2 / float that divides cg and the
// operands' alignment. Lanes: the fewest of 8, 16, 32 that cover the
// row's slots. Above 32 slots a warp holds V slots per lane for one pass
// over the row while V * VEC <= 8 floats; wider rows are cut into tiles
// of one slot per lane.
//
// Where a row takes more than one pass at any VEC (c > 32 * kMaxFloats),
// VEC need only divide c, with cg >= VEC: slots then straddle two groups
// where VEC does not divide cg (cg = 15 at G = 100: float4 tiles of 128
// columns instead of 188 tiles of 8 scalar columns), and such rows are cut
// into tiles of 32 lanes whatever the row count. Measured on the H100 at
// G = 100: 229-231 us a step at 32 lanes, 235-237 at 16, 245-254 at 8; at
// G = 10 (150 columns, one pass of V = 5 scalars) every straddling shape
// was slower (float2: 40-58 us against 32).
Shape choose_shape(int n_rows, int c, int cg, const float* h,
                   const float* init) {
  const bool passes = c > 32 * kMaxFloats;
  int vec = 4;
  while (vec > 1 &&
         ((passes ? c % vec != 0 || cg < vec : cg % vec != 0) ||
          !aligned(h, vec) || (init != nullptr && !aligned(init, vec))))
    vec /= 2;
  const int slots = c / vec;
  Shape s{32, vec, 1, 1, cg % vec != 0};
  if (s.straddle) {  // 32 lanes, one slot a lane
  } else if (slots <= 8) {
    s.lanes = 8;
  } else if (slots <= 16) {
    s.lanes = 16;
  } else if ((slots + 31) / 32 * vec <= kMaxFloats) {
    s.v = (slots + 31) / 32;
  } else if (n_rows >= kManyRows) {
    s.lanes = 8;
  }
  const int tile = s.lanes * s.vec * s.v;
  s.tiles = (c + tile - 1) / tile;
  return s;
}

template <int L, int VEC, int V, bool S = false>
void launch(const Shape& s, const int* row_ptr, const int* col,
            const float* w_g, const float* h, const float* init, float* out,
            int n_rows, int c, int cg, int nnz, cudaStream_t stream) {
  constexpr int kRows = ppnp::kBlock / L;
  const dim3 grid((n_rows + kRows - 1) / kRows, s.tiles);
  spmm_rows_kernel<L, VEC, V, S><<<grid, ppnp::kBlock, 0, stream>>>(
      row_ptr, col, w_g, h, init, out, n_rows, c, cg, nnz);
}

// The shapes choose_shape gives without straddling: V = 1 for 8 and 16
// lanes; for 32 lanes V * VEC <= 8.
template <int VEC>
void launch_vec(const Shape& s, const int* row_ptr, const int* col,
                const float* w_g, const float* h, const float* init,
                float* out, int n_rows, int c, int cg, int nnz,
                cudaStream_t stream) {
#define PPNP_LAUNCH(L_, V_)                                                 \
  launch<L_, VEC, (V_ * VEC <= kMaxFloats ? V_ : 1)>(                       \
      s, row_ptr, col, w_g, h, init, out, n_rows, c, cg, nnz, stream);     \
  break
  if (s.lanes == 8) {
    launch<8, VEC, 1>(s, row_ptr, col, w_g, h, init, out, n_rows, c, cg, nnz,
                      stream);
  } else if (s.lanes == 16) {
    launch<16, VEC, 1>(s, row_ptr, col, w_g, h, init, out, n_rows, c, cg,
                       nnz, stream);
  } else {
    switch (s.v) {
      case 1: PPNP_LAUNCH(32, 1);
      case 2: PPNP_LAUNCH(32, 2);
      case 3: PPNP_LAUNCH(32, 3);
      case 4: PPNP_LAUNCH(32, 4);
      case 5: PPNP_LAUNCH(32, 5);
      case 6: PPNP_LAUNCH(32, 6);
      case 7: PPNP_LAUNCH(32, 7);
      default: PPNP_LAUNCH(32, 8);
    }
  }
#undef PPNP_LAUNCH
}

// Straddling slots come only in tiles of 32 lanes, one slot a lane.
void launch_shape(const Shape& s, const int* row_ptr, const int* col,
                  const float* w_g, const float* h, const float* init,
                  float* out, int n_rows, int c, int cg, int nnz,
                  cudaStream_t stream) {
#define PPNP_ARGS s, row_ptr, col, w_g, h, init, out, n_rows, c, cg, nnz, stream
  switch (s.vec) {
    case 4:
      s.straddle ? launch<32, 4, 1, true>(PPNP_ARGS)
                 : launch_vec<4>(PPNP_ARGS);
      break;
    case 2:
      s.straddle ? launch<32, 2, 1, true>(PPNP_ARGS)
                 : launch_vec<2>(PPNP_ARGS);
      break;
    default:
      launch_vec<1>(PPNP_ARGS);
      break;
  }
#undef PPNP_ARGS
}

int spmm(const int* row_ptr, const int* col, const float* w_g,
         const float* h, const float* init, float* out, int n_rows,
         int groups, int cg, int nnz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c = groups * cg;
  launch_shape(choose_shape(n_rows, c, cg, h, init), row_ptr, col, w_g, h,
               init, out, n_rows, c, cg, nnz,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 on `stream` (PyTorch's current stream): G = `groups` planes w_g
// (groups x nnz, CSR order) over one pattern, H and out of groups * cg
// columns; K1 is G = 1 with cg = c. Returns cudaGetLastError(), 0 when the
// launch was accepted. `init` may be null.
extern "C" int ppnp_grouped_spmm_csr(const int* row_ptr, const int* col,
                                     const float* w_g, const float* h,
                                     const float* init, float* out,
                                     int n_rows, int groups, int cg, int nnz,
                                     int device, void* stream) {
  return spmm(row_ptr, col, w_g, h, init, out, n_rows, groups, cg, nnz,
              device, stream);
}

// The launch shape ppnp_grouped_spmm_csr takes for these widths and
// operands, into shape[0..4]: lanes, VEC, V, column tiles, and 1 where
// slots straddle two groups (else 0). Launches nothing; returns 0.
extern "C" int ppnp_grouped_spmm_shape(int n_rows, int groups, int cg,
                                        const float* h, const float* init,
                                        int* shape) {
  const Shape s = choose_shape(n_rows, groups * cg, cg, h, init);
  shape[0] = s.lanes;
  shape[1] = s.vec;
  shape[2] = s.v;
  shape[3] = s.tiles;
  shape[4] = s.straddle ? 1 : 0;
  return 0;
}
