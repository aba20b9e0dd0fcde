// The pair test of the matrix-free kernels, and the tile walk of the
// pair-CSR build.
//
// `pair_passes` decides, as the TPU kernels mask a pair: by original atom
// id (no self-pairs, no padding ids >= n) and, with a cutoff, sq <=
// cutoff_sq in float32 on the sq of `pair_geometry` (spring.cuh's
// roundings).  A pair that passes takes its spring constant (the table
// lookup of `table_compact` in the kTable instance, else the analytic
// rule); `pair_test` is the three in a row.  Two kernels call them, and
// only these two, so that both decide in the same way which pairs
// interact: the pair-CSR build (matfree_pairs.cu, through `TileWalk::walk`),
// which visits the neighbour tiles once per set-up and writes down the
// pairs that pass, and the dense-grid Hessian apply K12
// (matfree_hessian.cu), which tests every pair of its row block and column
// tile on every apply.
//
// The walk: a block of 32 row atoms (one per lane) visits the column atoms
// of a range, its four warps splitting them, and hands each pair that
// passes to the caller's visitor.  It is a chain of dependent
// shared-memory loads and compares per lane: four warps shorten the chain
// of the heaviest row tile fourfold, and the pair loop is unrolled
// fourfold (measured: one warp per block was latency-bound).  Warp w takes
// the staged column atoms q = w, w + 4, ..., so each warp sees its share of
// a row's pairs in a fixed order: range by range, then q.

#pragma once

#include <cuda_runtime.h>

#include "spring.cuh"

namespace springcraft {

constexpr int kWalkRows = 32;    // rows per block: one per lane
constexpr int kWalkWarps = 4;    // warps per block, splitting the columns
constexpr int kWalkThreads = kWalkRows * kWalkWarps;
constexpr int kWalkStage = 256;  // column atoms staged per step

// A lane's row atom: coordinates, original id and, for the table branch,
// its packed code (read by slot).
struct WalkRow {
  float x, y, z;
  int id;
  int code;
};

// d = r_row - r_j and sq = |d|^2 in spring.cuh's roundings.
__device__ __forceinline__ float pair_geometry(const WalkRow& row, float cx,
                                               float cy, float cz, float& dx,
                                               float& dy, float& dz) {
  dx = __fsub_rn(row.x, cx);
  dy = __fsub_rn(row.y, cy);
  dz = __fsub_rn(row.z, cz);
  return squared_distance(dx, dy, dz);
}

// Whether the pair (row, column atom jid) at squared distance sq interacts.
__device__ __forceinline__ bool pair_passes(const WalkRow& row, int jid,
                                            int n, float sq, float cutoff_sq,
                                            int has_cutoff) {
  return jid != row.id && jid < n && (!has_cutoff || sq <= cutoff_sq);
}

// The pair (row, column atom jid at cx, cy, cz with packed code jcode):
// d, sq, and whether the pair passes; if it does, kij is its spring
// constant.
template <bool kTable>
__device__ __forceinline__ bool pair_test(const WalkRow& row, float cx,
                                          float cy, float cz, int jid,
                                          int jcode, int n, int kind,
                                          float cutoff_sq, int has_cutoff,
                                          const PairTable& table, float& dx,
                                          float& dy, float& dz, float& sq,
                                          float& kij) {
  sq = pair_geometry(row, cx, cy, cz, dx, dy, dz);
  if (!pair_passes(row, jid, n, sq, cutoff_sq, has_cutoff)) return false;
  if constexpr (kTable)
    kij = table_constant(table, row.code, jcode, row.id, jid, sq);
  else
    kij = spring_constant(kind, sq);
  return true;
}

// What the table branch stages beside the column coordinates: nothing in an
// analytic instance.
template <bool kTable>
struct WalkCodes {};
template <>
struct WalkCodes<true> {
  int code[kWalkStage];
  float edges[kMaxEdges];
};

// The walk's shared memory; a kernel declares one `__shared__`.
template <bool kTable>
struct TileWalk {
  float x[kWalkStage], y[kWalkStage], z[kWalkStage];
  int id[kWalkStage];
  WalkCodes<kTable> codes;

  // Stage the bin edges once per block and point `table` at them; the first
  // barrier of `walk` publishes them.
  __device__ __forceinline__ void stage_edges(
      PairTable& table, const float* __restrict__ edges_sq) {
    if constexpr (kTable) {
      for (int e = threadIdx.x; e < table.n_edges; e += blockDim.x)
        codes.edges[e] = edges_sq[e];
      table.edges_sq = codes.edges;
    }
  }

  // Visit the column atoms [col_begin, col_end): visit(j, dx, dy, dz, sq,
  // k) for each pair (row, slot j) that passes `pair_test`.  `ids`
  // null means id = slot (the dense grid).  Every thread of the block calls
  // it (it holds two barriers per staged step); a lane with `row_ok` false
  // visits nothing.
  template <class Visit>
  __device__ __forceinline__ void walk(
      const float* __restrict__ coords, const int* __restrict__ ids,
      const int* __restrict__ atom_code, int col_begin, int col_end, int n,
      const WalkRow& row, bool row_ok, int kind, float cutoff_sq,
      int has_cutoff, const PairTable& table, Visit&& visit) {
    const int warp = threadIdx.x / kWalkRows;
    for (int j0 = col_begin; j0 < col_end; j0 += kWalkStage) {
      const int len = min(kWalkStage, col_end - j0);
      __syncthreads();
      for (int q = threadIdx.x; q < len; q += blockDim.x) {
        const int j = j0 + q;
        x[q] = coords[3 * j];
        y[q] = coords[3 * j + 1];
        z[q] = coords[3 * j + 2];
        id[q] = ids == nullptr ? j : ids[j];
        if constexpr (kTable) codes.code[q] = atom_code[j];
      }
      __syncthreads();
      if (!row_ok) continue;
#pragma unroll 4
      for (int q = warp; q < len; q += kWalkWarps) {
        int jcode = 0;
        if constexpr (kTable) jcode = codes.code[q];
        float dx, dy, dz, sq, kij;
        if (pair_test<kTable>(row, x[q], y[q], z[q], id[q], jcode, n, kind,
                              cutoff_sq, has_cutoff, table, dx, dy, dz, sq,
                              kij))
          visit(j0 + q, dx, dy, dz, sq, kij);
      }
    }
  }
};

}  // namespace springcraft
