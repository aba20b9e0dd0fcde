// Pair arithmetic shared by the assembly kernels (hessian_planes.cu,
// kirchhoff.cu, assembly_stitch.cu) and the matrix-free ones: the squared
// distance, the analytic spring-constant rules of
// springcraft_tpu/ops/pallas_kernels.py:95-108 (`_analytic_constants`),
// operation by operation, and the table lookup of the `table_compact`
// family, which computes what `_compact_tile_constants` (:130-185) and
// `pair_constant_planes` + `_planes_tile_constants` (:593-666) compute.
//
// The bin edges are ascending (the force field checks it).
//
// The _rn intrinsics keep nvcc from contracting multiply-adds into FMAs, so
// the cutoff decision and every pair value follow the same roundings as the
// plain PyTorch versions (ops/assembly.py).

#pragma once

#include <cuda_runtime.h>

namespace springcraft {

// Integer tags of the families, as ops/ffparams.py's FFParams.kind_code
// gives them.
constexpr int kInvariant = 0;
constexpr int kHinsen = 1;
constexpr int kPfenm = 2;
constexpr int kTableCompact = 3;

// dx * dx + dy * dy + dz * dz, in that order.
__device__ __forceinline__ float squared_distance(float dx, float dy,
                                                  float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Unmasked spring constant of a pair at squared distance `sq`.
__device__ __forceinline__ float spring_constant(int kind, float sq) {
  if (kind == kInvariant) return 1.0f;
  if (kind == kHinsen) {
    const float dist = fmaxf(__fsqrt_rn(sq), 2.9f);
    return dist < 4.0f
               ? __fsub_rn(__fmul_rn(dist, 860.0f), 2390.0f)
               : __fdiv_rn(1.28e6f, __fmul_rn(__fmul_rn(sq, sq), sq));
  }
  // pfenm
  return __fdiv_rn(1.0f, sq == 0.0f ? 1.0f : sq);
}

// Spring constant of the pair (p, q), zero unless p != q and, with a
// cutoff, sq <= cutoff_sq.
__device__ __forceinline__ float masked_spring_constant(int kind, float sq,
                                                        bool distinct,
                                                        float cutoff_sq,
                                                        int has_cutoff) {
  const bool valid = distinct && (!has_cutoff || sq <= cutoff_sq);
  return valid ? spring_constant(kind, sq) : 0.0f;
}

// The `table_compact` family as a kernel sees it.  The TPU kernels turn the
// per-pair gather into one-hot matrix products, or into precomputed
// (n_bins, n, n) pair planes with a select tree, because the TPU cannot
// gather; here a pair is one lookup.
struct PairTable {
  // (n_bins, 3, 20, 20) in device memory, contexts intra, inter, bonded;
  // batch-invariant and at most 125 KB (26 bins), so it lives in L2 and is
  // read through the read-only path.
  const float* tables;
  // Squared right bin edges (n_edges), staged in shared memory by the kernel.
  const float* edges_sq;
  int n_bins;
  int n_edges;
};

constexpr int kTypes = 20;
// Most bin edges a kernel with static shared memory stages (the matrix-free
// kernels; sdENM has 26).
constexpr int kMaxEdges = 64;

// Distance bin of squared distance `sq`: min(#{edges_sq < sq}, n_bins - 1),
// the count by halving steps from the largest power of two <= n_edges (a
// lower bound over the ascending edges): the same number of steps on every
// lane, no divergent loop.
__device__ __forceinline__ int table_bin(const PairTable& t, float sq) {
  int bin = 0;
  if (t.n_bins > 1 && t.n_edges > 0) {
    for (int step = 1 << (31 - __clz(t.n_edges)); step > 0; step >>= 1)
      if (bin + step <= t.n_edges && sq > t.edges_sq[bin + step - 1])
        bin += step;
    bin = min(bin, t.n_bins - 1);
  }
  return bin;
}

// Table entry of a pair of distinct atoms in distance bin `bin`: context
// bonded for neighbours in the original array whose lower one is flagged,
// else intra-chain for equal chain codes, else inter-chain.  `cp`, `cq` are
// the atoms' packed codes (type in bits 0-4, bonded-to-next flag in bit 5,
// chain code from bit 6) and `pos_p`, `pos_q` their positions in the
// original array: the assembly kernels pass the atom indices, the
// matrix-free kernels read the codes by slot of the Morton order and pass
// the original ids.
__device__ __forceinline__ const float* table_entry(const PairTable& t,
                                                    int bin, int cp, int cq,
                                                    int pos_p, int pos_q) {
  const int lower = pos_p < pos_q ? cp : cq;
  const int gap = pos_p < pos_q ? pos_q - pos_p : pos_p - pos_q;
  int context = (cp >> 6) == (cq >> 6) ? 0 : 1;
  if (gap == 1 && (lower & 32)) context = 2;
  return t.tables + ((bin * 3 + context) * kTypes + (cp & 31)) * kTypes +
         (cq & 31);
}

// Tabulated spring constant of a pair of distinct atoms at squared distance
// `sq` (table_bin, table_entry).
__device__ __forceinline__ float table_constant(const PairTable& t, int cp,
                                                int cq, int pos_p, int pos_q,
                                                float sq) {
  return __ldg(table_entry(t, table_bin(t, sq), cp, cq, pos_p, pos_q));
}

// Stage the coordinates of atoms [j0, j0 + len) of one conformer `c` (n, 3)
// as x[0:len], y[stride:stride + len], z[2 stride:2 stride + len] at `smem`.
// Every thread of the block calls it; the caller sets the barrier.
__device__ __forceinline__ void stage_coordinates(float* smem,
                                                  const float* __restrict__ c,
                                                  int j0, int len,
                                                  int stride) {
  c += 3 * static_cast<size_t>(j0);
  for (int i = threadIdx.x; i < 3 * len; i += blockDim.x) {
    const int atom = i / 3;
    smem[(i - atom * 3) * stride + atom] = c[i];
  }
}

// The cell-indexed bin lookup of the assembly kernels (kirchhoff.cu,
// hessian_planes.cu).  A halving search over the edges (table_bin) is five
// dependent shared-memory reads a pair; here a squared distance's cell
// (kCells cells up to the last edge) gives the count of the edges of the
// cells below it, and a climb over the edges of its own cell (about one)
// finishes it: the same bin, bit for bit.
constexpr int kCells = 256;

// Cell of a squared distance: floor(x * inv), at most kCells - 1; monotone
// in x (0 for NaN).
__device__ __forceinline__ int cell_of(float x, float inv) {
  return min(__float2int_rz(__fmul_rn(x, inv)), kCells - 1);
}

// Distance bins by cells: lo[c] is the count of edges whose cell is below
// c.  Every edge below a squared distance's cell lies below it (cells are
// monotone), so the count of edges below it starts at lo[cell] and climbs
// over the edges of its own cell: the bin of table_bin, bit for bit, in two
// dependent shared-memory reads instead of a halving search's five.
struct CellBins {
  const float* edges;
  const int* lo;
  float inv;
  int n_edges;
  int n_bins;

  __device__ __forceinline__ int bin(float sq) const {
    if (n_bins <= 1 || n_edges <= 0) return 0;
    int b = lo[cell_of(sq, inv)];
    while (b < n_edges && sq > edges[b]) ++b;
    return min(b, n_bins - 1);
  }
};

// Shared-memory bytes of stage_bins.
__host__ __device__ inline size_t cell_bins_bytes(int n_edges) {
  return static_cast<size_t>(n_edges) * sizeof(float) + kCells * sizeof(int);
}

// Stage the edges and their cells in shared memory at `smem` (n_edges
// floats, then kCells ints).  Every thread calls it; the caller sets the
// barrier.
__device__ __forceinline__ CellBins stage_bins(
    float* smem, const float* __restrict__ edges_sq, int n_edges,
    int n_bins) {
  int* lo = reinterpret_cast<int*>(smem + n_edges);
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x)
    smem[i] = edges_sq[i];
  const float last = n_edges > 0 ? __ldg(edges_sq + n_edges - 1) : 0.0f;
  const float inv =
      last > 0.0f ? __fdiv_rn(static_cast<float>(kCells - 1), last) : 0.0f;
  if (n_bins > 1 && n_edges > 0) {
    const int top = 1 << (31 - __clz(n_edges));
    for (int c = threadIdx.x; c < kCells; c += blockDim.x) {
      // the count of edges whose cell is below c (cells ascend with them)
      int k = 0;
      for (int step = top; step > 0; step >>= 1)
        if (k + step <= n_edges &&
            cell_of(__ldg(edges_sq + k + step - 1), inv) < c)
          k += step;
      lo[c] = k;
    }
  }
  return CellBins{smem, lo, inv, n_edges, n_bins};
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace springcraft
