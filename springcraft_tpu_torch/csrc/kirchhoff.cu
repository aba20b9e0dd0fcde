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
// (`_kirchhoff_ensemble_kernel`) are one per-pair lookup here (spring.cuh
// `table_entry`, with the bin below; see hessian_planes.cu).
//
// What bounds it on the H100: memory writes.  Each conformer writes n^2
// floats (46 MB for a 128-conformer chunk at n = 300, 12.6 MB for one
// structure of 1,776 atoms) and reads 12 n bytes of coordinates; the
// arithmetic per pair is ~10 flops, and the table branch adds a bin
// lookup and a table read per pair within the cutoff.
//
// Design: a row belongs to `lanes` lanes of one warp (32, or 16 or 8 when
// they waste fewer lanes on the row's last columns: 16 at n = 300), so a
// warp has one to four rows in flight and no row needs shared memory or a
// barrier.  A row's columns from its first 16-byte boundary on are
// groups of 4: each lane takes every lanes-th group, reads the 4 column
// atoms straight from device memory through L1 (three 16-byte loads where
// n % 4 == 0, kVectorLoads), computes their constants and writes -k with
// one 16-byte streaming store.  Where n % 4 != 0 a row starts 0-3 columns
// before a boundary: the row's lanes write those and the 0-3 after the
// last group with 4-byte stores, one a lane (writing the whole row 4 bytes at a
// time took 0.0369 ms at (128, 299) on an H100, against 0.0211 ms at
// (128, 300)).
// The row sum is finished in a fixed order without atomics: each lane sums
// its constants in order, in float64 (float32 sums of 256 terms a lane
// missed 1e-6 of max of the plain version at n = 8,192 without a cutoff),
// the row's lanes reduce by a fixed shuffle tree, and the diagonal is
// written last (the lane that holds its group writes that group, the
// diagonal in place; outside the groups, the row's first lane).  The TPU
// kernels carry the row sum across a sequential column-tile grid
// instead.
//
// The table branch's bin: spring.cuh's cell-indexed lookup (CellBins),
// shared with hessian_planes.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "spring.cuh"

namespace {

constexpr int kThreads = 256;

// Spring constant of row atom p and column atom q (codes cp, cq): zero
// unless p != q and, with a cutoff, sq <= cutoff_sq.
template <bool kTable>
__device__ __forceinline__ float pair_constant(
    int kind, float cutoff_sq, int has_cutoff,
    const springcraft::PairTable& table,
    const springcraft::CellBins& bins, int p,
    float px, float py, float pz, int cp, int q, float x, float y, float z,
    int cq) {
  const float sq = springcraft::squared_distance(
      __fsub_rn(px, x), __fsub_rn(py, y), __fsub_rn(pz, z));
  if constexpr (kTable) {
    const bool valid = q != p && (!has_cutoff || sq <= cutoff_sq);
    return valid ? __ldg(springcraft::table_entry(table, bins.bin(sq), cp,
                                                  cq, p, q))
                 : 0.0f;
  } else {
    return springcraft::masked_spring_constant(kind, sq, q != p, cutoff_sq,
                                               has_cutoff);
  }
}

template <bool kTable, bool kVectorLoads>
__global__ void __launch_bounds__(kThreads)
    kirchhoff_kernel(const float* __restrict__ coords,
                     float* __restrict__ out, int n, int lanes, int kind,
                     float cutoff_sq, int has_cutoff,
                     springcraft::PairTable table,
                     const float* __restrict__ edges_sq,
                     const int* __restrict__ atom_code) {
  extern __shared__ float s_bins[];
  springcraft::CellBins bins{};
  if constexpr (kTable) {
    bins = springcraft::stage_bins(s_bins, edges_sq, table.n_edges,
                                   table.n_bins);
    __syncthreads();
  }
  const int b = blockIdx.y;
  const float* conformer = coords + static_cast<size_t>(b) * n * 3;
  const int lane = threadIdx.x & 31;
  const int seg = lane / lanes, sub = lane - seg * lanes;
  const int p = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
                    (32 / lanes) + seg;
  float* row = out + (static_cast<size_t>(b) * n + p) * n;
  // the row's columns: `head` before its first 16-byte boundary (none
  // where n % 4 == 0), then `body` groups of 4 from there, then the rest
  // from `tail`
  const int head = min(
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15)
                       >> 2),
      n);
  const int body = (n - head) >> 2, tail = head + 4 * body;
  const int diag_group = p >= head && p < tail ? (p - head) >> 2 : -1;
  double partial = 0.0;
  float kd[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the diagonal's group
  if (p < n) {
    const float px = __ldg(conformer + 3 * p);
    const float py = __ldg(conformer + 3 * p + 1);
    const float pz = __ldg(conformer + 3 * p + 2);
    const int cp = kTable ? __ldg(atom_code + p) : 0;
    const int steps = (body - sub + lanes - 1) / lanes;
#pragma unroll 1
    for (int step = 0; step < steps; ++step) {
      const int g = sub + step * lanes, q0 = head + 4 * g;
      float x[4], y[4], z[4];
      int cq[4] = {0, 0, 0, 0};
      if constexpr (kVectorLoads) {  // head == 0
        const float4* c4 = reinterpret_cast<const float4*>(conformer) + 3 * g;
        const float4 u = __ldg(c4), v = __ldg(c4 + 1), w = __ldg(c4 + 2);
        x[0] = u.x, y[0] = u.y, z[0] = u.z, x[1] = u.w;
        y[1] = v.x, z[1] = v.y, x[2] = v.z, y[2] = v.w;
        z[2] = w.x, x[3] = w.y, y[3] = w.z, z[3] = w.w;
        if constexpr (kTable) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(atom_code) + g);
          cq[0] = c.x, cq[1] = c.y, cq[2] = c.z, cq[3] = c.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = __ldg(conformer + 3 * (q0 + j));
          y[j] = __ldg(conformer + 3 * (q0 + j) + 1);
          z[j] = __ldg(conformer + 3 * (q0 + j) + 2);
          if constexpr (kTable) cq[j] = __ldg(atom_code + q0 + j);
        }
      }
      float k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[j] = pair_constant<kTable>(kind, cutoff_sq, has_cutoff, table,
                                     bins, p, px, py, pz, cp, q0 + j, x[j],
                                     y[j], z[j], cq[j]);
        partial += k[j];
      }
      if (g != diag_group) {
        __stcs(reinterpret_cast<float4*>(row + q0),
               make_float4(-k[0], -k[1], -k[2], -k[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) kd[j] = -k[j];
      }
    }
    // the at most 6 columns outside the groups, one a lane (lanes >= 8)
    if (sub < head + n - tail) {
      const int q = sub < head ? sub : tail + sub - head;
      const float k = pair_constant<kTable>(
          kind, cutoff_sq, has_cutoff, table, bins, p, px, py, pz, cp, q,
          __ldg(conformer + 3 * q), __ldg(conformer + 3 * q + 1),
          __ldg(conformer + 3 * q + 2), kTable ? __ldg(atom_code + q) : 0);
      partial += k;
      if (q != p) __stcs(row + q, -k);
    }
  }
  // the row sum: the row's lanes in a fixed shuffle tree (rows past n add
  // zeros), then the diagonal: the lane that holds its group writes that
  // group, the diagonal in place; outside the groups, the row's first lane
  // (the lane that took its column wrote nothing there)
  for (int off = lanes / 2; off > 0; off >>= 1)
    partial += __shfl_xor_sync(0xffffffffu, partial, off);
  if (p < n) {
    if (diag_group < 0) {
      if (sub == 0) __stcs(row + p, static_cast<float>(partial));
    } else if (sub == diag_group % lanes) {
      const int jd = (p - head) & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j == jd) kd[j] = static_cast<float>(partial);
      __stcs(reinterpret_cast<float4*>(row + head + 4 * diag_group),
             make_float4(kd[0], kd[1], kd[2], kd[3]));
    }
  }
}

template <bool kTable>
cudaError_t launch(bool vector, const dim3& grid, size_t smem,
                   cudaStream_t stream, const float* coords, float* out,
                   int n, int lanes, int kind, float cutoff_sq,
                   int has_cutoff, const springcraft::PairTable& table,
                   const float* edges_sq, const int* atom_code) {
  if (vector)
    kirchhoff_kernel<kTable, true><<<grid, kThreads, smem, stream>>>(
        coords, out, n, lanes, kind, cutoff_sq, has_cutoff, table, edges_sq,
        atom_code);
  else
    kirchhoff_kernel<kTable, false><<<grid, kThreads, smem, stream>>>(
        coords, out, n, lanes, kind, cutoff_sq, has_cutoff, table, edges_sq,
        atom_code);
  return cudaGetLastError();
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
    // lanes of a row: 32, unless a half or a quarter warp wastes fewer
    // lanes on the row's last column groups
    const int groups = (n + 3) / 4;
    int lanes = 32;
    while (lanes > 8 && 10 * ((groups + lanes - 1) / lanes) * lanes >
                            11 * groups)
      lanes /= 2;
    const int rows_per_block = kThreads / lanes;
    const dim3 grid((n + rows_per_block - 1) / rows_per_block, batch);
    const bool table = kind == springcraft::kTableCompact;
    // 16-byte column loads: rows start on 16-byte boundaries (head == 0),
    // conformers and codes aligned
    const bool vector =
        n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(coords) % 16 == 0 &&
        (!table || reinterpret_cast<uintptr_t>(atom_code) % 16 == 0);
    const springcraft::PairTable t{tables, nullptr, n_bins, n_edges};
    const auto s = static_cast<cudaStream_t>(stream);
    if (table)
      return static_cast<int>(launch<true>(
          vector, grid, springcraft::cell_bins_bytes(n_edges), s,
          coords, out, n, lanes, kind, cutoff_sq, has_cutoff, t, edges_sq,
          atom_code));
    return static_cast<int>(launch<false>(vector, grid, 0, s, coords, out, n,
                                          lanes, kind, cutoff_sq, has_cutoff,
                                          t, edges_sq, atom_code));
  }
  return static_cast<int>(cudaGetLastError());
}
