// Matrix-free GNM Kirchhoff apply, Y = K X, without the Kirchhoff matrix:
// coordinates (n, 3) and X (n, k) to Y (n, k),
//
//   y_i = -sum_j k_ij x_j + (sum_j k_ij) x_i.
//
// Replaces the TPU kernel springcraft_tpu/ops/matfree.py:964
// `_sparse_kirchhoff_kernel` (K14, reached through
// `kirchhoff_apply_pallas_sparse` and `_launch_sparse_segments`): the
// row-sorted tile pairs of `tile_neighbor_lists` as a CSR, pairs masked by
// original atom id.  Analytic families and the tabulated `table_compact`
// family (the TPU kernel's table branch, matfree.py:1000-1010): a second
// instantiation looks a passing pair up in the type tables, codes read by
// slot, the bonded test by original id (see matfree_hessian.cu).
//
// What bounds it on the H100: instruction issue for the cutoff tests, then
// X's traffic.  Per pair that passes the cutoff the work is one FMA per
// column (2 flops), so the arithmetic is small; X in and Y out are 4 n k
// bytes each.  The TPU multiplied the whole (T, T) constant plane of every
// visited tile pair on its MXU, under 1% of it within the cutoff at the
// benchmark's density; here each pair is tested and only passing pairs
// touch X.
//
// Design, as matfree_hessian.cu: a block owns 32 rows of one parent tile and
// walks its CSR neighbour tiles, its four warps splitting the column atoms
// (the walk is latency-bound) and meeting in shared memory at the end;
// column coordinates and ids staged in shared memory 256 atoms at a time,
// x_j of a passing pair read as warp-uniform loads through L1 (a staged
// column block of X would be read over a hundred times more often than
// used), kCols = 32 columns of Y and the degree in registers, each output
// row written once, no atomics.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kRows * kWarps;
constexpr int kStage = 256;
constexpr int kCols = 32;

// What the table branch stages beside the column coordinates: nothing in
// the analytic instance.
template <bool kTable>
struct TableStage {};
template <>
struct TableStage<true> {
  int code[kStage];
  float edges[springcraft::kMaxEdges];
};

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
    kirchhoff_apply_kernel(const float* __restrict__ coords,
                           const int* __restrict__ ids,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ col_tiles,
                           const float* __restrict__ x,
                           float* __restrict__ out, int n, int k, int tile,
                           int kind, float cutoff_sq, int has_cutoff,
                           springcraft::PairTable table,
                           const float* __restrict__ edges_sq,
                           const int* __restrict__ atom_code) {
  __shared__ float sx[kStage], sy[kStage], sz[kStage];
  __shared__ int sid[kStage];
  __shared__ TableStage<kTable> staged;
  __shared__ float partial[kWarps - 1][kCols + 1][kRows];
  const int lane = threadIdx.x % kRows, warp = threadIdx.x / kRows;
  if constexpr (kTable) {
    // published by the first barrier of the walk
    for (int e = threadIdx.x; e < table.n_edges; e += kThreads)
      staged.edges[e] = edges_sq[e];
    table.edges_sq = staged.edges;
  }

  const int per_tile = (tile + kRows - 1) / kRows;
  const int t = blockIdx.x / per_tile;
  const int row0 = t * tile + (blockIdx.x - t * per_tile) * kRows;
  const int row_end = min(n, (t + 1) * tile);
  if (row0 >= row_end) return;  // whole block
  const int i = row0 + lane;
  const bool active = i < row_end;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, k - c0);

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int pid = n;
  int cp = 0;  // the row atom's code, by slot
  if (active) {
    px = coords[3 * i];
    py = coords[3 * i + 1];
    pz = coords[3 * i + 2];
    pid = ids[i];
    if constexpr (kTable) cp = atom_code[i];
  }
  const bool row_ok = pid < n;

  float y[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) y[c] = 0.0f;
  float deg = 0.0f;

  for (int p = row_ptr[t]; p < row_ptr[t + 1]; ++p) {
    const int col_begin = col_tiles[p] * tile;
    const int col_end = min(n, col_begin + tile);
    for (int j0 = col_begin; j0 < col_end; j0 += kStage) {
      const int len = min(kStage, col_end - j0);
      __syncthreads();
      for (int q = threadIdx.x; q < len; q += kThreads) {
        const int j = j0 + q;
        sx[q] = coords[3 * j];
        sy[q] = coords[3 * j + 1];
        sz[q] = coords[3 * j + 2];
        sid[q] = ids[j];
        if constexpr (kTable) staged.code[q] = atom_code[j];
      }
      __syncthreads();
      if (!row_ok) continue;
#pragma unroll 4
      for (int q = warp; q < len; q += kWarps) {
        const int jid = sid[q];
        const float sq = springcraft::squared_distance(
            __fsub_rn(px, sx[q]), __fsub_rn(py, sy[q]), __fsub_rn(pz, sz[q]));
        if (jid == pid || jid >= n || (has_cutoff && !(sq <= cutoff_sq)))
          continue;
        float kij;
        if constexpr (kTable)
          kij = springcraft::table_constant(table, cp, staged.code[q], pid,
                                            jid, sq);
        else
          kij = springcraft::spring_constant(kind, sq);
        deg += kij;
        const float* xj = x + static_cast<size_t>(j0 + q) * k + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (c < kc) y[c] -= kij * __ldg(xj + c);
      }
    }
  }
  // warps 1.. hand their partial sums to warp 0
  if (warp > 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) partial[warp - 1][c][lane] = y[c];
    partial[warp - 1][kCols][lane] = deg;
  }
  __syncthreads();
  if (warp > 0 || !active) return;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) y[c] += partial[w][c][lane];
    deg += partial[w][kCols][lane];
  }
  const float* xi = x + static_cast<size_t>(i) * k + c0;
  float* yi = out + static_cast<size_t>(i) * k + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < kc) yi[c] = y[c] + deg * xi[c];
}

}  // namespace

// tables (n_bins, 3, 20, 20), edges_sq (n_edges <= kMaxEdges) and atom_code
// (n, by slot) are read only for kind == table_compact and may be null
// otherwise.
extern "C" int sc_kirchhoff_apply_sparse(const float* coords, const int* ids,
                                         const int* row_ptr,
                                         const int* col_tiles, const float* x,
                                         float* out, int n, int k, int tile,
                                         int kind, float cutoff_sq,
                                         int has_cutoff, const float* tables,
                                         const float* edges_sq,
                                         const int* atom_code, int n_bins,
                                         int n_edges, void* stream) {
  if (n_edges > springcraft::kMaxEdges) return cudaErrorInvalidValue;
  if (n > 0 && k > 0 && tile > 0) {
    const int n_tiles = (n + tile - 1) / tile;
    const dim3 grid(n_tiles * ((tile + kRows - 1) / kRows),
                    (k + kCols - 1) / kCols);
    const auto kernel = kind == springcraft::kTableCompact
                            ? kirchhoff_apply_kernel<true>
                            : kirchhoff_apply_kernel<false>;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        coords, ids, row_ptr, col_tiles, x, out, n, k, tile, kind, cutoff_sq,
        has_cutoff, table, edges_sq, atom_code);
  }
  return static_cast<int>(cudaGetLastError());
}
