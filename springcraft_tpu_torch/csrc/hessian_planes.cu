// ANM Hessian assembly of a conformer batch, in two output layouts: the
// nine xyz component planes (9, B, n, n), or the dense xyz-layout Hessians
// (B, 3n, 3n).
//
// Replaces the TPU kernels
// * springcraft_tpu/ops/pallas_kernels.py:688 `_hessian_ensemble_kernel`
//   (reached through `hessian_pallas_ensemble(..., raw_planes=True)`), as
//   the planes layout (entry sc_hessian_planes);
// * springcraft_tpu/ops/pallas_kernels.py:191 `_hessian_kernel` (reached
//   through `hessian_pallas`, whose nine plane outputs are then
//   concatenated at :364-374), as the xyz layout (entry sc_hessian_xyz):
//   the concatenation is folded into the store address,
//   H[b, a n + p, e n + q].  The single structure runs at B = 1; the JAX
//   package's vmap of `hessian_pallas` over an ensemble runs at B = chunk.
// Analytic families and the tabulated `table_compact` family: both TPU
// kernels' table branches (the one-hot products of :130-185 in
// `_hessian_kernel`, the precomputed pair planes of :593-666 in
// `_hessian_ensemble_kernel`) are one per-pair lookup here (spring.cuh,
// `table_constant`), so neither the products nor the planes are carried
// over.  The type tables stay in device memory (batch-invariant, at most
// 125 KB, read through L2); per-atom codes and bin edges are staged in
// shared memory behind the coordinates.
//
// What bounds it on the H100: memory writes.  Each conformer writes
// 9 * n^2 floats (415 MB for a 128-conformer chunk at n = 300, 114 MB for
// one structure at n = 1776) and reads only 12 n bytes of coordinates; the
// arithmetic per pair is ~30 flops.
//
// Design: the TPU kernels carry the row sums for the diagonal across their
// sequential column-tile grid in scratch and visit the diagonal tile last.
// GPU blocks run in no order, so here one WARP owns one whole row p of one
// conformer: it sweeps every column q with its lanes along q (so each of
// the nine stores is one coalesced 128-byte line per step, in either
// layout), keeps the nine row sums in registers, reduces them with warp
// shuffles and writes the diagonal entries itself — no cross-block
// reduction and no second pass.  A block of 8 warps stages the column
// atoms' coordinates in shared memory (structure of arrays, 12 bytes an
// atom, 16 plus the edges for the tabulated family): the whole conformer
// in one piece up to 4,096 atoms (21 KB at n = 1776; the tabulated family
// passes the 48 KB default from n = 3066 and then opts in), and beyond that
// tile by tile of 2,048 atoms with a barrier per tile, as the TPU kernel
// walks its column tiles, so a structure of any size assembles (one
// Hessian at n = 30,000 is 32.4 GB).  The row atom's coordinates, code and
// nine sums live in registers across the tiles.  Offsets are size_t.  One
// body serves both: a whole conformer is one tile (a second instantiation
// that kept the old single-barrier staging for it measured slower).  The
// column sweep is unrolled fourfold: a warp at n = 300 has ten steps of nine
// dependent-address stores, and four steps in flight took K1 at (128, 300)
// from 0.283 to 0.229 ms (unrolled twofold it took 0.39).
//
// Arithmetic follows the JAX kernels operation by operation (spring.cuh);
// the diagonal's summation order differs.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kTable>
__global__ void hessian_kernel(const float* __restrict__ coords,
                               float* __restrict__ out, int batch, int n,
                               int tile, int kind, float cutoff_sq,
                               int has_cutoff, springcraft::PairTable table,
                               const float* __restrict__ edges_sq,
                               const int* __restrict__ atom_code,
                               int xyz_layout) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const float* conformer = coords + static_cast<size_t>(b) * n * 3;
  springcraft::ColumnTile<kTable> cols(smem, tile, edges_sq, table);

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const bool active = p < n;  // a warp past the last row only helps staging

  // Element (a, e, q) of row p lies at row[a * a_stride + e * e_stride + q].
  const size_t nn = static_cast<size_t>(n) * n;
  float* row;
  size_t a_stride, e_stride;
  if (xyz_layout) {
    row = out + (static_cast<size_t>(b) * 3 * n + p) * 3 * n;
    a_stride = 3 * nn;
    e_stride = n;
  } else {
    row = out + (static_cast<size_t>(b) * n + p) * n;
    e_stride = static_cast<size_t>(batch) * nn;
    a_stride = 3 * e_stride;
  }

  float px = 0.0f, py = 0.0f, pz = 0.0f;
  int cp = 0;
  if (active) {
    px = conformer[3 * static_cast<size_t>(p)];
    py = conformer[3 * static_cast<size_t>(p) + 1];
    pz = conformer[3 * static_cast<size_t>(p) + 2];
    if constexpr (kTable) cp = atom_code[p];
  }
  float acc[9];
#pragma unroll
  for (int ab = 0; ab < 9; ++ab) acc[ab] = 0.0f;

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
      float d[3];
      d[0] = __fsub_rn(px, x[s]);
      d[1] = __fsub_rn(py, y[s]);
      d[2] = __fsub_rn(pz, z[s]);
      const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
      const float k = springcraft::masked_pair_constant<kTable>(
          kind, table, cp, kTable ? cols.code[s] : 0, p, q, sq, cutoff_sq,
          has_cutoff);
      const float g = __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float ga = __fmul_rn(g, d[a]);
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float v = __fmul_rn(ga, d[e]);
          acc[3 * a + e] += v;
          if (q != p) row[a * a_stride + e * e_stride + q] = v;
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int ab = 0; ab < 9; ++ab) {
    float s = acc[ab];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[ab] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        row[a * a_stride + e * e_stride + p] = -acc[3 * a + e];
  }
}

int launch(const float* coords, float* out, int batch, int n, int kind,
           float cutoff_sq, int has_cutoff, const float* tables,
           const float* edges_sq, const int* atom_code, int n_bins,
           int n_edges, int xyz_layout, void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    const int tile = springcraft::assembly_column_tile(n);
    const size_t smem = springcraft::assembly_smem_bytes(tile, kind, n_edges);
    const auto kernel = kind == springcraft::kTableCompact
                            ? hessian_kernel<true>
                            : hessian_kernel<false>;
    const cudaError_t opt = springcraft::allow_shared_memory(kernel, smem);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, 32 * kWarpsPerBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        coords, out, batch, n, tile, kind, cutoff_sq, has_cutoff, table,
        edges_sq, atom_code, xyz_layout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables (n_bins, 3, 20, 20), edges_sq (n_edges) and atom_code (n) are read
// only for kind == table_compact and may be null otherwise.
extern "C" int sc_hessian_planes(const float* coords, float* out, int batch,
                                 int n, int kind, float cutoff_sq,
                                 int has_cutoff, const float* tables,
                                 const float* edges_sq, const int* atom_code,
                                 int n_bins, int n_edges, void* stream) {
  return launch(coords, out, batch, n, kind, cutoff_sq, has_cutoff, tables,
                edges_sq, atom_code, n_bins, n_edges, 0, stream);
}

extern "C" int sc_hessian_xyz(const float* coords, float* out, int batch,
                              int n, int kind, float cutoff_sq,
                              int has_cutoff, const float* tables,
                              const float* edges_sq, const int* atom_code,
                              int n_bins, int n_edges, void* stream) {
  return launch(coords, out, batch, n, kind, cutoff_sq, has_cutoff, tables,
                edges_sq, atom_code, n_bins, n_edges, 1, stream);
}
