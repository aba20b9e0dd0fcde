// GNM Kirchhoff matrices of a conformer batch, (B, n, 3) -> (B, n, n):
// -k off the diagonal, the row sum of k on it.
//
// Replaces the TPU kernels
// * springcraft_tpu/ops/pallas_kernels.py:766 `_kirchhoff_ensemble_kernel`
//   (reached through `kirchhoff_pallas_ensemble`);
// * springcraft_tpu/ops/pallas_kernels.py:413 `_kirchhoff_kernel` (reached
//   through `kirchhoff_pallas`): the single structure runs at B = 1, and
//   the JAX package's vmap of `kirchhoff_pallas` over an ensemble (its
//   GNM pipelines for the analytic families) runs at B = chunk.
// Analytic families and the tabulated `table_compact` family, whose
// one-hot products (`_kirchhoff_kernel`) and precomputed pair planes
// (`_kirchhoff_ensemble_kernel`) are one per-pair lookup here (spring.cuh,
// `table_constant`; see hessian_planes.cu).
//
// What bounds it on the H100: memory writes.  Each conformer writes n^2
// floats (46 MB for a 128-conformer chunk at n = 300) and reads 12 n bytes
// of coordinates; the arithmetic per pair is ~10 flops.
//
// Design, as in hessian_planes.cu: the TPU kernels carry the row sum across
// a sequential column-tile grid and write the diagonal tile last; here one
// WARP owns one whole row p of one conformer, its lanes sweep the columns
// (one coalesced 128-byte store per step), the row sum stays in a register
// and is reduced by warp shuffle, and lane 0 writes the diagonal.  No
// cross-block reduction.  A block of 8 warps stages the column atoms'
// coordinates in shared memory (12 bytes an atom, 16 plus the edges for the
// tabulated family): the whole conformer up to 4,096 atoms, tiles of 2,048
// with a barrier per tile beyond, so any size assembles.  The column sweep
// is unrolled fourfold, as in hessian_planes.cu.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kTable>
__global__ void kirchhoff_kernel(const float* __restrict__ coords,
                                 float* __restrict__ out, int n, int tile,
                                 int kind, float cutoff_sq, int has_cutoff,
                                 springcraft::PairTable table,
                                 const float* __restrict__ edges_sq,
                                 const int* __restrict__ atom_code) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const float* conformer = coords + static_cast<size_t>(b) * n * 3;
  springcraft::ColumnTile<kTable> cols(smem, tile, edges_sq, table);

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool active = p < n;  // a warp past the last row only helps staging

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int cp = 0;
  if (active) {
    px = conformer[3 * static_cast<size_t>(p)];
    py = conformer[3 * static_cast<size_t>(p) + 1];
    pz = conformer[3 * static_cast<size_t>(p) + 2];
    if constexpr (kTable) cp = atom_code[p];
  }
  float* row = out + (static_cast<size_t>(b) * n + p) * n;
  float acc = 0.0f;
  for (int j0 = 0; j0 < n; j0 += tile) {
    const int len = min(tile, n - j0);
    cols.load(conformer, atom_code, j0, len);
    if (!active) continue;
    const float* x = cols.xyz;
    const float* y = x + cols.stride;
    const float* z = y + cols.stride;
#pragma unroll 4
    for (int s = lane; s < len; s += 32) {
      const int q = j0 + s;
      const float sq = springcraft::squared_distance(
          __fsub_rn(px, x[s]), __fsub_rn(py, y[s]), __fsub_rn(pz, z[s]));
      const float k = springcraft::masked_pair_constant<kTable>(
          kind, table, cp, kTable ? cols.code[s] : 0, p, q, sq, cutoff_sq,
          has_cutoff);
      acc += k;
      if (q != p) row[q] = -k;
    }
  }
  if (!active) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) row[p] = acc;
}

}  // namespace

// tables (n_bins, 3, 20, 20), edges_sq (n_edges) and atom_code (n) are read
// only for kind == table_compact and may be null otherwise.
extern "C" int sc_kirchhoff(const float* coords, float* out, int batch, int n,
                            int kind, float cutoff_sq, int has_cutoff,
                            const float* tables, const float* edges_sq,
                            const int* atom_code, int n_bins, int n_edges,
                            void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    const int tile = springcraft::assembly_column_tile(n);
    const size_t smem = springcraft::assembly_smem_bytes(tile, kind, n_edges);
    const auto kernel = kind == springcraft::kTableCompact
                            ? kirchhoff_kernel<true>
                            : kirchhoff_kernel<false>;
    const cudaError_t opt = springcraft::allow_shared_memory(kernel, smem);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, 32 * kWarpsPerBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        coords, out, n, tile, kind, cutoff_sq, has_cutoff, table, edges_sq,
        atom_code);
  }
  return static_cast<int>(cudaGetLastError());
}
