// The pair CSR of the block-sparse matrix-free applies, built once per
// set-up: for coordinates (n, 3) in Morton order and the row-sorted tile
// pairs of `tile_neighbor_lists` (a CSR over row tiles), every ordered pair
// (i, j) that passes the test of the TPU kernels (original ids distinct and
// below n, sq <= cutoff_sq in float32), as row_ptr (n + 1), the slot j and
// the spring constant k_ij (table lookup or analytic rule) of each pair.
// 8 bytes per ordered pair: 15 MB at n = 30,000 under the invariant 13 A
// field, 31 MB under sdENM.
//
// Not a TPU kernel: the set-up of K13 and K14 (matfree_hessian.cu,
// matfree_kirchhoff.cu), which replace springcraft_tpu/ops/matfree.py:807
// and :964.  The TPU kernels tested every visited tile pair on every
// apply; here the test runs once per solver, and the table lookup of
// `table_compact` with it, so the applies carry no table branch.
//
// Two passes of one kernel over the tile walk of tile_walk.cuh (whose pair
// test K12 runs too): the first counts the passing pairs of each row
// per warp into counts (n, 4); the caller turns them into offsets with one
// cumulative sum (row r starts at offsets[4 r]); the second walks again and
// writes each warp's pairs from its offset on.  A row's list is warp 0's
// pairs, then warp 1's, ..., each in walk order, so the same inputs give
// the same list bit for bit, with no atomics.
//
// What bounds it: the walk's 2.8e8 tests at n = 30,000 (the instruction
// rate: a chain of shared-memory loads and compares per lane), twice; the
// list it writes is small.

#include <cuda_runtime.h>

#include "spring.cuh"
#include "tile_walk.cuh"

namespace {

using springcraft::kWalkRows;
using springcraft::kWalkWarps;

// One block: rows [row0, row0 + 32) of row tile t (clipped to the tile and
// to n).  kWrite false: counts[4 i + w] = the pairs warp w passes for row
// i; true: warp w writes them from offsets[4 i + w] on.
template <bool kTable, bool kWrite>
__global__ void __launch_bounds__(springcraft::kWalkThreads)
    pair_csr_kernel(const float* __restrict__ coords,
                    const int* __restrict__ ids,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ col_tiles, int n, int tile,
                    int kind, float cutoff_sq, int has_cutoff,
                    springcraft::PairTable table,
                    const float* __restrict__ edges_sq,
                    const int* __restrict__ atom_code,
                    int* __restrict__ counts,
                    const int* __restrict__ offsets, int* __restrict__ slots,
                    float* __restrict__ kvals) {
  __shared__ springcraft::TileWalk<kTable> walk;
  walk.stage_edges(table, edges_sq);
  const int lane = threadIdx.x % kWalkRows, warp = threadIdx.x / kWalkRows;
  const int per_tile = (tile + kWalkRows - 1) / kWalkRows;
  const int t = blockIdx.x / per_tile;
  const int row0 = t * tile + (blockIdx.x - t * per_tile) * kWalkRows;
  const int row_end = min(n, (t + 1) * tile);
  if (row0 >= row_end) return;  // whole block
  const int i = row0 + lane;
  const bool active = i < row_end;

  springcraft::WalkRow row{0.0f, 0.0f, 0.0f, n, 0};
  if (active) {
    row = springcraft::WalkRow{coords[3 * i], coords[3 * i + 1],
                               coords[3 * i + 2], ids[i],
                               kTable ? atom_code[i] : 0};
  }
  const bool row_ok = row.id < n;

  int pos = kWrite && active ? offsets[4 * i + warp] : 0;
  for (int p = tile_ptr[t]; p < tile_ptr[t + 1]; ++p) {
    const int col_begin = col_tiles[p] * tile;
    walk.walk(coords, ids, atom_code, col_begin, min(n, col_begin + tile), n,
              row, row_ok, kind, cutoff_sq, has_cutoff, table,
              [&](int j, float, float, float, float, float kij) {
                if constexpr (kWrite) {
                  slots[pos] = j;
                  kvals[pos] = kij;
                }
                ++pos;
              });
  }
  if (!kWrite && active) counts[4 * i + warp] = pos;
}

template <bool kWrite>
int launch(const float* coords, const int* ids, const int* tile_ptr,
           const int* col_tiles, int n, int tile, int kind, float cutoff_sq,
           int has_cutoff, const float* tables, const float* edges_sq,
           const int* atom_code, int n_bins, int n_edges, int* counts,
           const int* offsets, int* slots, float* kvals, void* stream) {
  static_assert(kWalkWarps == 4, "counts and offsets hold 4 per row");
  if (n_edges > springcraft::kMaxEdges) return cudaErrorInvalidValue;
  if (n > 0 && tile > 0) {
    const int n_tiles = (n + tile - 1) / tile;
    const int blocks = n_tiles * ((tile + kWalkRows - 1) / kWalkRows);
    const auto kernel = kind == springcraft::kTableCompact
                            ? pair_csr_kernel<true, kWrite>
                            : pair_csr_kernel<false, kWrite>;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<blocks, springcraft::kWalkThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        coords, ids, tile_ptr, col_tiles, n, tile, kind, cutoff_sq,
        has_cutoff, table, edges_sq, atom_code, counts, offsets, slots,
        kvals);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1: counts (4 n) per row and warp.  tables (n_bins, 3, 20, 20),
// edges_sq (n_edges <= kMaxEdges) and atom_code (n, by slot) are read only
// for kind == table_compact and may be null otherwise.
extern "C" int sc_pair_csr_count(const float* coords, const int* ids,
                                 const int* tile_ptr, const int* col_tiles,
                                 int* counts, int n, int tile, int kind,
                                 float cutoff_sq, int has_cutoff,
                                 const float* tables, const float* edges_sq,
                                 const int* atom_code, int n_bins,
                                 int n_edges, void* stream) {
  return launch<false>(coords, ids, tile_ptr, col_tiles, n, tile, kind,
                       cutoff_sq, has_cutoff, tables, edges_sq, atom_code,
                       n_bins, n_edges, counts, nullptr, nullptr, nullptr,
                       stream);
}

// Pass 2: slots and k (P) from offsets (4 n + 1), the exclusive cumulative
// sum of pass 1's counts.
extern "C" int sc_pair_csr_fill(const float* coords, const int* ids,
                                const int* tile_ptr, const int* col_tiles,
                                const int* offsets, int* slots, float* kvals,
                                int n, int tile, int kind, float cutoff_sq,
                                int has_cutoff, const float* tables,
                                const float* edges_sq, const int* atom_code,
                                int n_bins, int n_edges, void* stream) {
  return launch<true>(coords, ids, tile_ptr, col_tiles, n, tile, kind,
                      cutoff_sq, has_cutoff, tables, edges_sq, atom_code,
                      n_bins, n_edges, nullptr, offsets, slots, kvals,
                      stream);
}
