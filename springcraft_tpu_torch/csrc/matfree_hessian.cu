// Matrix-free ANM Hessian apply, Y = H X, without the Hessian: coordinates
// (n, 3) and X (3n, k) in xyz plane layout (row a n + i, column c) to Y of
// the same shape,
//
//   y_i = sum_j g_ij d_ij (d_ij . x_j) - (sum_j g_ij d_ij d_ij^T) x_i,
//   d_ij = r_i - r_j,  g_ij = -k_ij / |d_ij|^2.
//
// Replaces the TPU kernels
// * springcraft_tpu/ops/matfree.py:807 `_sparse_apply_kernel` (K13, reached
//   through `hessian_apply_pallas_sparse` and `_launch_sparse_segments`):
//   entry sc_hessian_apply_sparse walks the row-sorted tile pairs of
//   `tile_neighbor_lists` as a CSR and masks pairs by original atom id;
// * springcraft_tpu/ops/matfree.py:385 `_apply_kernel` (K12, reached through
//   `hessian_apply_pallas`): entry sc_hessian_apply_dense, the same body over
//   every column atom, ids = arange(n).
// Analytic families and the tabulated `table_compact` family (the table
// branch of both TPU kernels, matfree.py:389-421 and :813-856): a pair that
// passes the id and cutoff test takes k = tables[bin][context][type_p]
// [type_q] (spring.cuh, `table_constant`) instead of the analytic rule.  The
// kernel is instantiated with and without the lookup, so the analytic
// instances carry none of it.  In Morton order the per-atom codes are read
// by slot (the caller permutes them with the coordinates) while the bonded
// test and "which atom is the lower one" go by original id, the same ids
// that mask self-pairs and padding.
//
// What bounds it on the H100: instruction issue, not bytes.  X in and Y out
// are 12 n k bytes each (35 MB at n = 30,000, k = 48), but the cutoff test
// runs on every visited pair: the TPU grid multiplies the nine (T, T) planes
// of every visited tile pair on its MXU, and at the benchmark's density
// (13 A, 256-atom tiles) under 1% of those pairs lie within the cutoff
// (0.68% at n = 30,000: 2.8e8 visited, 1.9e6 within).  Here a thread owns
// one row atom and tests each column atom of its tile's neighbour tiles
// (about 12 instructions); only pairs that pass do per-column work, in
// rank-one form: s = d . x_j (3 FMAs), y_i += (g d) s (3 FMAs), 6 against
// the nine planes' 18.  The diagonal block D_i = sum g d d^T (6 values)
// stays in registers and y_i -= D_i x_i is applied once at the end.
//
// Design: one block owns a sub-tile of 32 rows of one parent tile (tile =
// 256: 8 blocks per tile, so the 36-80 neighbour tiles of a row tile at
// n = 30k spread over many blocks), walks its parent tile's CSR neighbour
// list with no order across blocks and no atomics, and writes each output
// row once.  Its four warps hold the same 32 rows and split the column
// atoms (warp w takes every fourth): the walk is a chain of dependent
// shared-memory loads and compares, latency-bound with one warp per block
// (measured), so four warps shorten the heaviest row tile's chain fourfold
// and quadruple the warps in flight; their partial sums meet in shared
// memory at the end.  Column coordinates and ids are staged in shared
// memory 256 atoms at a time (the table branch stages their codes beside
// them, and the bin edges once per block) and read as broadcasts; X is NOT
// staged: a
// pair passes the cutoff in under 1% of the tests, so a staged column block
// of X would be read 100 times more often than used.  The x_j values of a
// passing pair are warp-uniform loads through L1.  Each block covers
// kCols = 16 columns of X in registers (y: 48 floats); grid.y covers the
// rest of k, repeating the walk.  k is not padded to 128 (a TPU lane
// artefact).
//
// Numerics: the pair values (d, |d|^2, k, g) follow the plain version's
// roundings (spring.cuh); the sums run pair by pair in float32, in another
// order than the plain version's plane products, so the two agree to a
// stated tolerance, not bit for bit.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kRows = 32;    // rows per block: one per lane
constexpr int kWarps = 4;    // warps per block, splitting the columns
constexpr int kThreads = kRows * kWarps;
constexpr int kStage = 256;  // column atoms staged per step
constexpr int kCols = 16;    // columns of X per block
constexpr int kAcc = 3 * kCols + 6;  // a lane's sums: y and D

// What the table branch stages beside the column coordinates: nothing in an
// analytic instance.
template <bool kTable>
struct TableStage {};
template <>
struct TableStage<true> {
  int code[kStage];
  float edges[springcraft::kMaxEdges];
};

// One block: rows [row0, row0 + kRows) of parent tile t (clipped to the tile
// and to n), columns [c0, c0 + kc) of X.  Dense walks every column atom;
// otherwise the column tiles cols[row_ptr[t] .. row_ptr[t + 1]).
template <bool Dense, bool kTable>
__global__ void __launch_bounds__(kThreads)
    hessian_apply_kernel(const float* __restrict__ coords,
                         const int* __restrict__ ids,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ col_tiles,
                         const float* __restrict__ x, float* __restrict__ out,
                         int n, int k, int tile, int kind, float cutoff_sq,
                         int has_cutoff, springcraft::PairTable table,
                         const float* __restrict__ edges_sq,
                         const int* __restrict__ atom_code) {
  __shared__ float sx[kStage], sy[kStage], sz[kStage];
  __shared__ int sid[kStage];
  __shared__ TableStage<kTable> staged;
  __shared__ float partial[kWarps - 1][kAcc][kRows];
  const int lane = threadIdx.x % kRows, warp = threadIdx.x / kRows;
  if constexpr (kTable) {
    // published by the first barrier of the walk
    for (int e = threadIdx.x; e < table.n_edges; e += kThreads)
      staged.edges[e] = edges_sq[e];
    table.edges_sq = staged.edges;
  }

  int t = 0, row_end = n, row0;
  if (Dense) {
    row0 = blockIdx.x * kRows;
  } else {
    const int per_tile = (tile + kRows - 1) / kRows;
    t = blockIdx.x / per_tile;
    row0 = t * tile + (blockIdx.x - t * per_tile) * kRows;
    row_end = min(n, (t + 1) * tile);
  }
  if (row0 >= row_end) return;  // whole block
  const int i = row0 + lane;
  const bool active = i < row_end;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, k - c0);

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int pid = n;  // inactive rows take no pair
  int cp = 0;   // the row atom's code, by slot
  if (active) {
    px = coords[3 * i];
    py = coords[3 * i + 1];
    pz = coords[3 * i + 2];
    pid = Dense ? i : ids[i];
    if constexpr (kTable) cp = atom_code[i];
  }
  const bool row_ok = pid < n;

  float y0[kCols], y1[kCols], y2[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) y0[c] = y1[c] = y2[c] = 0.0f;
  float d00 = 0.0f, d01 = 0.0f, d02 = 0.0f, d11 = 0.0f, d12 = 0.0f,
        d22 = 0.0f;
  const size_t plane = static_cast<size_t>(n) * k;

  const int p_begin = Dense ? 0 : row_ptr[t];
  const int p_end = Dense ? 1 : row_ptr[t + 1];
  for (int p = p_begin; p < p_end; ++p) {
    int col_begin = 0, col_end = n;
    if (!Dense) {
      const int ct = col_tiles[p];
      col_begin = ct * tile;
      col_end = min(n, col_begin + tile);
    }
    for (int j0 = col_begin; j0 < col_end; j0 += kStage) {
      const int len = min(kStage, col_end - j0);
      __syncthreads();
      for (int q = threadIdx.x; q < len; q += kThreads) {
        const int j = j0 + q;
        sx[q] = coords[3 * j];
        sy[q] = coords[3 * j + 1];
        sz[q] = coords[3 * j + 2];
        sid[q] = Dense ? j : ids[j];
        if constexpr (kTable) staged.code[q] = atom_code[j];
      }
      __syncthreads();
      if (!row_ok) continue;
#pragma unroll 4
      for (int q = warp; q < len; q += kWarps) {
        const int jid = sid[q];
        const float dx = __fsub_rn(px, sx[q]);
        const float dy = __fsub_rn(py, sy[q]);
        const float dz = __fsub_rn(pz, sz[q]);
        const float sq = springcraft::squared_distance(dx, dy, dz);
        if (jid == pid || jid >= n || (has_cutoff && !(sq <= cutoff_sq)))
          continue;
        float kij;
        if constexpr (kTable)
          kij = springcraft::table_constant(table, cp, staged.code[q], pid,
                                            jid, sq);
        else
          kij = springcraft::spring_constant(kind, sq);
        const float g = -__fdiv_rn(kij, sq == 0.0f ? 1.0f : sq);
        const float gx = g * dx, gy = g * dy, gz = g * dz;
        d00 += gx * dx;
        d01 += gx * dy;
        d02 += gx * dz;
        d11 += gy * dy;
        d12 += gy * dz;
        d22 += gz * dz;
        const float* xj = x + static_cast<size_t>(j0 + q) * k + c0;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < kc) {
            const float s = dx * __ldg(xj + c) + dy * __ldg(xj + plane + c) +
                            dz * __ldg(xj + 2 * plane + c);
            y0[c] += gx * s;
            y1[c] += gy * s;
            y2[c] += gz * s;
          }
        }
      }
    }
  }
  // warps 1.. hand their partial sums to warp 0
  if (warp > 0) {
    float(*mine)[kRows] = partial[warp - 1];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      mine[c][lane] = y0[c];
      mine[kCols + c][lane] = y1[c];
      mine[2 * kCols + c][lane] = y2[c];
    }
    mine[3 * kCols][lane] = d00;
    mine[3 * kCols + 1][lane] = d01;
    mine[3 * kCols + 2][lane] = d02;
    mine[3 * kCols + 3][lane] = d11;
    mine[3 * kCols + 4][lane] = d12;
    mine[3 * kCols + 5][lane] = d22;
  }
  __syncthreads();
  if (warp > 0 || !active) return;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      y0[c] += partial[w][c][lane];
      y1[c] += partial[w][kCols + c][lane];
      y2[c] += partial[w][2 * kCols + c][lane];
    }
    d00 += partial[w][3 * kCols][lane];
    d01 += partial[w][3 * kCols + 1][lane];
    d02 += partial[w][3 * kCols + 2][lane];
    d11 += partial[w][3 * kCols + 3][lane];
    d12 += partial[w][3 * kCols + 4][lane];
    d22 += partial[w][3 * kCols + 5][lane];
  }
  const float* xi = x + static_cast<size_t>(i) * k + c0;
  float* yi = out + static_cast<size_t>(i) * k + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < kc) {
      const float a = xi[c], b = xi[plane + c], e = xi[2 * plane + c];
      yi[c] = y0[c] - (d00 * a + d01 * b + d02 * e);
      yi[plane + c] = y1[c] - (d01 * a + d11 * b + d12 * e);
      yi[2 * plane + c] = y2[c] - (d02 * a + d12 * b + d22 * e);
    }
  }
}

}  // namespace

// tables (n_bins, 3, 20, 20), edges_sq (n_edges <= kMaxEdges) and atom_code
// (n, by slot) are read only for kind == table_compact and may be null
// otherwise.
extern "C" int sc_hessian_apply_sparse(const float* coords, const int* ids,
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
                            ? hessian_apply_kernel<false, true>
                            : hessian_apply_kernel<false, false>;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        coords, ids, row_ptr, col_tiles, x, out, n, k, tile, kind, cutoff_sq,
        has_cutoff, table, edges_sq, atom_code);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sc_hessian_apply_dense(const float* coords, const float* x,
                                      float* out, int n, int k, int kind,
                                      float cutoff_sq, int has_cutoff,
                                      const float* tables,
                                      const float* edges_sq,
                                      const int* atom_code, int n_bins,
                                      int n_edges, void* stream) {
  if (n_edges > springcraft::kMaxEdges) return cudaErrorInvalidValue;
  if (n > 0 && k > 0) {
    const dim3 grid((n + kRows - 1) / kRows, (k + kCols - 1) / kCols);
    const auto kernel = kind == springcraft::kTableCompact
                            ? hessian_apply_kernel<true, true>
                            : hessian_apply_kernel<true, false>;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        coords, nullptr, nullptr, nullptr, x, out, n, k, n, kind, cutoff_sq,
        has_cutoff, table, edges_sq, atom_code);
  }
  return static_cast<int>(cudaGetLastError());
}
