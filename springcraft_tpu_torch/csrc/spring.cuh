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

// Spring constant of the pair of atoms p, q (array positions, codes cp, cq),
// zero unless p != q and, with a cutoff, sq <= cutoff_sq: the table lookup
// with kTable, else the analytic rule of `kind`.  The kernels are
// instantiated once for each, so the analytic instance carries nothing of
// the lookup.
template <bool kTable>
__device__ __forceinline__ float masked_pair_constant(int kind,
                                                      const PairTable& t,
                                                      int cp, int cq, int p,
                                                      int q, float sq,
                                                      float cutoff_sq,
                                                      int has_cutoff) {
  if constexpr (kTable) {
    const bool valid = p != q && (!has_cutoff || sq <= cutoff_sq);
    return valid ? table_constant(t, cp, cq, p, q, sq) : 0.0f;
  } else {
    return masked_spring_constant(kind, sq, p != q, cutoff_sq, has_cutoff);
  }
}

// Column atoms the assembly kernels stage at a time: a whole conformer up to
// kWholeConformer atoms (48 KB of coordinates), tiles of kColumnTile beyond.
constexpr int kWholeConformer = 4096;
constexpr int kColumnTile = 2048;

__host__ __device__ inline int assembly_column_tile(int n) {
  return n <= kWholeConformer ? n : kColumnTile;
}

// Shared-memory bytes of one staged column tile (structure of arrays) plus,
// for the tabulated family, its per-atom codes and the edges.
__host__ __device__ inline size_t assembly_smem_bytes(int tile, int kind,
                                                      int n_edges) {
  size_t bytes = 3 * static_cast<size_t>(tile) * sizeof(float);
  if (kind == kTableCompact)
    bytes += static_cast<size_t>(tile) * sizeof(int) +
             static_cast<size_t>(n_edges) * sizeof(float);
  return bytes;
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

// The shared memory of an assembly kernel: a column tile's coordinates, then
// (kTable) its atom codes and the bin edges.
template <bool kTable>
struct ColumnTile {
  float* xyz;
  int* code;
  int stride;

  // Lay the buffers out over `smem` and stage the edges (once per block).
  __device__ __forceinline__ ColumnTile(float* smem, int tile,
                                        const float* __restrict__ edges,
                                        PairTable& t)
      : xyz(smem), code(reinterpret_cast<int*>(smem + 3 * tile)),
        stride(tile) {
    if constexpr (kTable) {
      float* s_edges = reinterpret_cast<float*>(code + tile);
      for (int i = threadIdx.x; i < t.n_edges; i += blockDim.x)
        s_edges[i] = edges[i];
      t.edges_sq = s_edges;
    }
  }

  // Stage atoms [j0, j0 + len) between two barriers: the first lets every
  // warp finish with the tile before, the second publishes this one.
  __device__ __forceinline__ void load(const float* __restrict__ c,
                                       const int* __restrict__ atom_code,
                                       int j0, int len) {
    __syncthreads();
    stage_coordinates(xyz, c, j0, len, stride);
    if constexpr (kTable)
      for (int i = threadIdx.x; i < len; i += blockDim.x)
        code[i] = atom_code[j0 + i];
    __syncthreads();
  }
};

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace springcraft
