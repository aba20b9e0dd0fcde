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
// `_hessian_ensemble_kernel`) are one per-pair lookup here (spring.cuh
// `table_entry`), so neither the products nor the planes are carried over.
//
// What bounds it on the H100: memory writes.  Each conformer writes
// 9 * n^2 floats (415 MB for a 128-conformer chunk at n = 300, 114 MB for
// one structure at n = 1776) and reads 12 n bytes of coordinates; the
// arithmetic per pair is ~30 flops.
//
// Design: one warp owns one row p of one conformer, with no shared memory
// or barrier (but the table branch's edges and cells) and the column atoms
// read straight from device memory through L1 (three 16-byte loads for 4
// atoms where n % 4 == 0, kVector), so a row can have any number of
// columns (one Hessian at n = 30,000 is 32.4 GB; offsets are size_t).  A
// row's columns from its first 16-byte boundary on are groups of 4: lane l
// takes groups l, l + 32, ..., computes their 4 pairs' 36 entries and
// writes them as nine 16-byte streaming stores, one per output segment
// (a, e): plane (a, e), row b n + p in the planes layout; row
// b 3n + a n + p, columns e n + q in the xyz layout.  So each store of the
// warp covers 512 contiguous bytes of one segment: a row on 16 or 8 lanes
// (two or four rows a warp, as kirchhoff.cu) was slower on an H100 at
// (128, 300), as were shared-memory copies of the block's rows' table
// slices and a type-major copy of the tables.  The step loop is unrolled
// twice.
// Where n % 4 != 0 the segments of a row need not share their 16-byte
// boundaries: the groups follow the segment that shares its boundary with
// the most others (`ref`), and a segment `mis` floats off it writes a group
// as two 8-byte stores (mis 2) or a 4-, an 8- and a 4-byte store (mis 1,
// 3); the 0-3 columns before the first group and after the last are
// written one a lane, 4 bytes a segment.  `ref` and `mis` are the same for
// every row of a launch.
// The diagonal is the negated row sum, finished without atomics: each lane
// sums its entries in float64 (float32 sums of 256 terms a lane missed
// 1e-6 of max at n = 8,192 in kirchhoff.cu), the warp reduces by a fixed
// shuffle tree, and the lane that wrote column p's group (its entry there
// is +-0) writes the nine diagonal entries over it, after its own 16-byte
// stores; outside the groups lane 0 writes them.  Keeping that group's 36
// entries in registers to write it once took more registers a thread
// (fewer warps an SM) and was slower.  The TPU kernels carry the row sums
// across their sequential column-tile grid instead.
// The table branch's bin is spring.cuh's cell-indexed lookup (CellBins).
//
// Arithmetic follows the JAX kernels operation by operation (spring.cuh):
// every off-diagonal entry is (g d_a) d_e with g = -k / sq, rounded as the
// plain version rounds it; the diagonal's summation order differs.

#include <cuda_runtime.h>

#include <cstdint>

#include "spring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;  // a warp a row

struct Args {
  const float* coords;
  float* out;
  // (n_bins, 3, 20, 20), edges_sq (n_edges) and atom_code (n): the table
  // branch only
  const float* tables;
  const float* edges_sq;
  const int* atom_code;
  int batch, n, kind, has_cutoff, n_bins, n_edges, xyz_layout;
  float cutoff_sq;
  // the segment 3 a + e whose 16-byte boundaries the column groups follow,
  // and each segment's first column past it, mod 4 (2 bits a segment)
  int ref, mis;
};

// Columns q0 .. q0 + 3 of one segment at `dst` (= segment + q0), `mis`
// floats past a 16-byte boundary: the widest stores that stay aligned.
__device__ __forceinline__ void store_group(float* dst, int mis, float v0,
                                            float v1, float v2, float v3) {
  if (mis == 0) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v0, v1, v2, v3));
  } else if (mis == 2) {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
    __stcs(reinterpret_cast<float2*>(dst + 2), make_float2(v2, v3));
  } else {
    __stcs(dst, v0);
    __stcs(reinterpret_cast<float2*>(dst + 1), make_float2(v1, v2));
    __stcs(dst + 3, v3);
  }
}

// The nine entries H[a n + p, e n + q] (v[3 a + e]) of the pair p, q: the
// displacement, the masked spring constant (the table lookup with kTable),
// g = -k / sq and (g d_a) d_e.
template <bool kTable>
__device__ __forceinline__ void pair_entries(
    const Args& args, const springcraft::PairTable& table,
    const springcraft::CellBins& bins, int p, float px, float py, float pz,
    int cp, int q, float x, float y, float z, int cq, float v[9]) {
  float d[3];
  d[0] = __fsub_rn(px, x);
  d[1] = __fsub_rn(py, y);
  d[2] = __fsub_rn(pz, z);
  const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
  float k;
  if constexpr (kTable) {
    const bool valid =
        q != p && (!args.has_cutoff || sq <= args.cutoff_sq);
    k = valid ? __ldg(springcraft::table_entry(table, bins.bin(sq), cp, cq,
                                               p, q))
              : 0.0f;
  } else {
    k = springcraft::masked_spring_constant(args.kind, sq, q != p,
                                            args.cutoff_sq, args.has_cutoff);
  }
  const float g = __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ga = __fmul_rn(g, d[a]);
#pragma unroll
    for (int e = 0; e < 3; ++e) v[3 * a + e] = __fmul_rn(ga, d[e]);
  }
}

template <bool kTable, bool kVector>
__global__ void __launch_bounds__(kThreads) hessian_kernel(const Args args) {
  extern __shared__ float s_bins[];
  const springcraft::PairTable table{args.tables, nullptr, args.n_bins,
                                     args.n_edges};
  springcraft::CellBins bins{};
  if constexpr (kTable) {
    bins = springcraft::stage_bins(s_bins, args.edges_sq, args.n_edges,
                                   args.n_bins);
    __syncthreads();
  }
  const int n = args.n;
  const int b = blockIdx.y;
  const float* conformer = args.coords + static_cast<size_t>(b) * n * 3;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kRows + (threadIdx.x >> 5);

  // Segment (a, e) of row p starts at base + a * a_stride + e * e_stride.
  const size_t nn = static_cast<size_t>(n) * n;
  float* base;
  size_t a_stride, e_stride;
  if (args.xyz_layout) {
    base = args.out + (static_cast<size_t>(b) * 3 * n + p) * 3 * n;
    a_stride = 3 * nn;
    e_stride = n;
  } else {
    base = args.out + (static_cast<size_t>(b) * n + p) * n;
    e_stride = static_cast<size_t>(args.batch) * nn;
    a_stride = 3 * e_stride;
  }
  // the row's columns: `head` before the first 16-byte boundary of segment
  // `ref` (none with kVector), then `body` groups of 4 from there, then the
  // rest from `tail`
  int head = 0;
  if constexpr (!kVector) {
    const float* ref = base + (args.ref / 3) * a_stride +
                       (args.ref % 3) * e_stride;
    head = min(static_cast<int>(
                   ((16 - (reinterpret_cast<uintptr_t>(ref) & 15)) & 15) >>
                   2),
               n);
  }
  const int body = (n - head) >> 2, tail = head + 4 * body;
  const int diag_group = p >= head && p < tail ? (p - head) >> 2 : -1;

  double acc[9];
#pragma unroll
  for (int ab = 0; ab < 9; ++ab) acc[ab] = 0.0;
  if (p < n) {  // a warp past the last row only stages the bins
    const float px = __ldg(conformer + 3 * p);
    const float py = __ldg(conformer + 3 * p + 1);
    const float pz = __ldg(conformer + 3 * p + 2);
    const int cp = kTable ? __ldg(args.atom_code + p) : 0;
    const int steps = (body - lane + 31) / 32;
#pragma unroll 2
    for (int step = 0; step < steps; ++step) {
      const int g = lane + 32 * step, q0 = head + 4 * g;
      float x[4], y[4], z[4];
      int cq[4] = {0, 0, 0, 0};
      if constexpr (kVector) {  // head == 0
        const float4* c4 = reinterpret_cast<const float4*>(conformer) + 3 * g;
        const float4 u = __ldg(c4), v = __ldg(c4 + 1), w = __ldg(c4 + 2);
        x[0] = u.x, y[0] = u.y, z[0] = u.z, x[1] = u.w;
        y[1] = v.x, z[1] = v.y, x[2] = v.z, y[2] = v.w;
        z[2] = w.x, x[3] = w.y, y[3] = w.z, z[3] = w.w;
        if constexpr (kTable) {
          const int4 c =
              __ldg(reinterpret_cast<const int4*>(args.atom_code) + g);
          cq[0] = c.x, cq[1] = c.y, cq[2] = c.z, cq[3] = c.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = __ldg(conformer + 3 * (q0 + j));
          y[j] = __ldg(conformer + 3 * (q0 + j) + 1);
          z[j] = __ldg(conformer + 3 * (q0 + j) + 2);
          if constexpr (kTable) cq[j] = __ldg(args.atom_code + q0 + j);
        }
      }
      float v[4][9];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pair_entries<kTable>(args, table, bins, p, px, py, pz, cp, q0 + j,
                             x[j], y[j], z[j], cq[j], v[j]);
#pragma unroll
        for (int ab = 0; ab < 9; ++ab) acc[ab] += v[j][ab];
      }
#pragma unroll
      for (int ab = 0; ab < 9; ++ab)
        store_group(base + (ab / 3) * a_stride + (ab % 3) * e_stride + q0,
                    kVector ? 0 : (args.mis >> (2 * ab)) & 3, v[0][ab],
                    v[1][ab], v[2][ab], v[3][ab]);
    }
    // the at most 6 columns outside the groups, one a lane
    if (!kVector && lane < head + n - tail) {
      const int q = lane < head ? lane : tail + lane - head;
      float v[9];
      pair_entries<kTable>(
          args, table, bins, p, px, py, pz, cp, q, __ldg(conformer + 3 * q),
          __ldg(conformer + 3 * q + 1), __ldg(conformer + 3 * q + 2),
          kTable ? __ldg(args.atom_code + q) : 0, v);
#pragma unroll
      for (int ab = 0; ab < 9; ++ab) {
        acc[ab] += v[ab];
        if (q != p)
          __stcs(base + (ab / 3) * a_stride + (ab % 3) * e_stride + q,
                 v[ab]);
      }
    }
  }
  if (p >= n) return;  // the whole warp: a warp is one row
  // the row sums: the warp's lanes in a fixed shuffle tree, then the
  // diagonal over the +-0 that the lane of its group wrote there (the same
  // thread, so after it); outside the groups lane 0 (the lane that took
  // its column wrote nothing there)
#pragma unroll
  for (int ab = 0; ab < 9; ++ab)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[ab] += __shfl_xor_sync(0xffffffffu, acc[ab], off);
  if (lane == (diag_group < 0 ? 0 : (diag_group & 31))) {
#pragma unroll
    for (int ab = 0; ab < 9; ++ab)
      __stcs(base + (ab / 3) * a_stride + (ab % 3) * e_stride + p,
             static_cast<float>(-acc[ab]));
  }
}

template <bool kTable>
cudaError_t launch_instance(bool vector, const dim3& grid, size_t smem,
                            cudaStream_t stream, const Args& args) {
  if (vector)
    hessian_kernel<kTable, true><<<grid, kThreads, smem, stream>>>(args);
  else
    hessian_kernel<kTable, false><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

int launch(Args args, void* stream) {
  const int n = args.n;
  if (args.batch > 0 && n > 0) {
    const dim3 grid((n + kRows - 1) / kRows, args.batch);
    const bool table = args.kind == springcraft::kTableCompact;
    // Each segment's first column (row 0 of conformer 0), mod 4 floats;
    // every other row's segments lie the same whole rows apart, so `ref`
    // and `mis` hold for every row.
    const unsigned long long nn = static_cast<unsigned long long>(n) * n;
    int cls[9], count[4] = {0, 0, 0, 0};
    for (int ab = 0; ab < 9; ++ab) {
      const int a = ab / 3, e = ab % 3;
      const unsigned long long offset =
          args.xyz_layout
              ? a * 3ull * nn + e * static_cast<unsigned long long>(n)
              : ab * static_cast<unsigned long long>(args.batch) * nn;
      cls[ab] = static_cast<int>(
          (reinterpret_cast<uintptr_t>(args.out) / 4 + offset) & 3);
      ++count[cls[ab]];
    }
    args.ref = 0;
    for (int ab = 1; ab < 9; ++ab)
      if (count[cls[ab]] > count[cls[args.ref]]) args.ref = ab;
    args.mis = 0;
    for (int ab = 0; ab < 9; ++ab)
      args.mis |= ((cls[ab] - cls[args.ref]) & 3) << (2 * ab);
    // 16-byte column loads and stores: every segment on a 16-byte boundary
    // (n % 4 == 0), conformers and codes aligned
    const bool vector =
        n % 4 == 0 && reinterpret_cast<uintptr_t>(args.out) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(args.coords) % 16 == 0 &&
        (!table || reinterpret_cast<uintptr_t>(args.atom_code) % 16 == 0);
    const auto s = static_cast<cudaStream_t>(stream);
    if (table)
      return static_cast<int>(launch_instance<true>(
          vector, grid, springcraft::cell_bins_bytes(args.n_edges), s,
          args));
    return static_cast<int>(launch_instance<false>(vector, grid, 0, s, args));
  }
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* coords, float* out, int batch, int n, int kind,
               float cutoff_sq, int has_cutoff, const float* tables,
               const float* edges_sq, const int* atom_code, int n_bins,
               int n_edges, int xyz_layout) {
  Args args{};
  args.coords = coords;
  args.out = out;
  args.tables = tables;
  args.edges_sq = edges_sq;
  args.atom_code = atom_code;
  args.batch = batch;
  args.n = n;
  args.kind = kind;
  args.has_cutoff = has_cutoff;
  args.n_bins = n_bins;
  args.n_edges = n_edges;
  args.xyz_layout = xyz_layout;
  args.cutoff_sq = cutoff_sq;
  return args;
}

}  // namespace

// tables (n_bins, 3, 20, 20), edges_sq (n_edges) and atom_code (n) are read
// only for kind == table_compact and may be null otherwise.
extern "C" int sc_hessian_planes(const float* coords, float* out, int batch,
                                 int n, int kind, float cutoff_sq,
                                 int has_cutoff, const float* tables,
                                 const float* edges_sq, const int* atom_code,
                                 int n_bins, int n_edges, void* stream) {
  return launch(make_args(coords, out, batch, n, kind, cutoff_sq, has_cutoff,
                          tables, edges_sq, atom_code, n_bins, n_edges, 0),
                stream);
}

extern "C" int sc_hessian_xyz(const float* coords, float* out, int batch,
                              int n, int kind, float cutoff_sq,
                              int has_cutoff, const float* tables,
                              const float* edges_sq, const int* atom_code,
                              int n_bins, int n_edges, void* stream) {
  return launch(make_args(coords, out, batch, n, kind, cutoff_sq, has_cutoff,
                          tables, edges_sq, atom_code, n_bins, n_edges, 1),
                stream);
}
