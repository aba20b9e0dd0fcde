// Matrix-free ANM Hessian apply, Y = H X, without the Hessian: coordinates
// (n, 3) and X (3n, k) in xyz plane layout (row a n + i, column c) to Y of
// the same shape,
//
//   y_i = sum_j g_ij d_ij (d_ij . x_j) - (sum_j g_ij d_ij d_ij^T) x_i,
//   d_ij = r_i - r_j,  g_ij = -k_ij / |d_ij|^2.
//
// Two kernels:
//
// * sc_hessian_apply_pairs replaces springcraft_tpu/ops/matfree.py:807
//   `_sparse_apply_kernel` (K13, reached through
//   `hessian_apply_pallas_sparse`): a gather over the pair CSR that
//   matfree_pairs.cu builds once per set-up (row_ptr, slot j and k_ij of
//   every ordered pair within the cutoff, Morton order).  The TPU kernel
//   multiplied the nine (T, T) planes of every neighbour tile pair on its
//   MXU, under 1% of them within the cutoff; walking those tile pairs on
//   every apply bound this kernel by its instruction rate (2.8e8 tests per
//   apply at n = 30,000 for 1.9e6 pairs).  With the list, what is left is the gather:
//   12 flops per gathered float, so the bound is the P x 3k x 4 bytes of
//   x_j rows read from L2 (X itself is 12 n k bytes and stays there).  The
//   design (pair_gather.cuh): a warp per row and up to 64 columns, lanes on
//   (neighbour, float4 column group), d, |d|^2 and g computed once per pair
//   by the lane that read it and broadcast, the next step's x_j rows in
//   flight during this step's FMAs, the diagonal block D_i summed per lane
//   and y_i -= D_i x_i last, each output row written once, no atomics and
//   no table branch (the constant is in the list).
// * sc_hessian_apply_dense replaces matfree.py:385 `_apply_kernel` (K12,
//   reached through `hessian_apply_pallas`): the tile walk of tile_walk.cuh
//   over every column atom on every apply, ids = slots, analytic families
//   and the table branch of `table_compact` (codes staged beside the
//   column coordinates).  A cutoff-free family passes every pair, so the
//   work is 12 k + 30 flops per pair and the walk's tests are not in the
//   way.  A block owns 32 rows (one per lane) and kCols = 16 columns of X
//   in registers (grid.y covers the rest of k); its four warps split the
//   column atoms and meet in shared memory at the end.  X is not staged:
//   under a cutoff a staged column block would be read far more often than
//   used.
//
// Numerics: the pair values (d, |d|^2, k, g) follow the plain versions'
// roundings (spring.cuh); the sums run pair by pair in float32, in another
// order than the plain versions' plane products, so the two agree to a
// stated tolerance, not bit for bit.

#include <cuda_runtime.h>

#include "pair_gather.cuh"
#include "spring.cuh"
#include "tile_walk.cuh"

namespace {

using springcraft::kFullMask;
using springcraft::kWalkRows;
using springcraft::kWalkWarps;

// ---------------------------------------------------------------------------
// K13: the gather over the pair CSR
// ---------------------------------------------------------------------------

// Row i of Y for this warp's lane columns.
template <int VEC, int GPL>
__device__ __forceinline__ void hessian_row(
    int i, const springcraft::LaneColumns<VEC, GPL>& cols, int lane,
    int lpn, const float* __restrict__ coords,
    const int* __restrict__ row_ptr, const int* __restrict__ slots,
    const float* __restrict__ kvals, const float* __restrict__ x,
    float* __restrict__ out, size_t plane, int k) {
  const float px = coords[3 * i], py = coords[3 * i + 1],
              pz = coords[3 * i + 2];

  float y[3][GPL][VEC];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < GPL; ++q)
#pragma unroll
      for (int c = 0; c < VEC; ++c) y[a][q][c] = 0.0f;
  // D_i over the pairs this lane read
  float d00 = 0.0f, d01 = 0.0f, d02 = 0.0f, d11 = 0.0f, d12 = 0.0f,
        d22 = 0.0f;

  const int p1 = row_ptr[i + 1];
  for (int base = row_ptr[i]; base < p1; base += 32) {
    // this lane's pair of the batch; a lane past the end reads row i with
    // g = 0
    int mj = i;
    float mdx = 0.0f, mdy = 0.0f, mdz = 0.0f, mg = 0.0f;
    if (base + lane < p1) {
      mj = slots[base + lane];
      const float kij = kvals[base + lane];
      mdx = __fsub_rn(px, coords[3 * mj]);
      mdy = __fsub_rn(py, coords[3 * mj + 1]);
      mdz = __fsub_rn(pz, coords[3 * mj + 2]);
      const float sq = springcraft::squared_distance(mdx, mdy, mdz);
      mg = -__fdiv_rn(kij, sq == 0.0f ? 1.0f : sq);
      const float gx = mg * mdx, gy = mg * mdy, gz = mg * mdz;
      d00 += gx * mdx;
      d01 += gx * mdy;
      d02 += gx * mdz;
      d11 += gy * mdy;
      d12 += gy * mdz;
      d22 += gz * mdz;
    }
    const int steps = (min(32, p1 - base) + cols.npw - 1) / cols.npw;
    float cur[3][GPL][VEC], nxt[3][GPL][VEC];
    int src = cols.ns;
    {
      const size_t j = __shfl_sync(kFullMask, mj, src);
#pragma unroll
      for (int a = 0; a < 3; ++a) cols.load(x + a * plane + j * k, cur[a]);
    }
    for (int s = 0; s < steps; ++s) {
      const float dx = __shfl_sync(kFullMask, mdx, src);
      const float dy = __shfl_sync(kFullMask, mdy, src);
      const float dz = __shfl_sync(kFullMask, mdz, src);
      const float g = __shfl_sync(kFullMask, mg, src);
      src += cols.npw;
      if (s + 1 < steps) {
        const size_t j = __shfl_sync(kFullMask, mj, src);
#pragma unroll
        for (int a = 0; a < 3; ++a) cols.load(x + a * plane + j * k, nxt[a]);
      }
      const float gx = g * dx, gy = g * dy, gz = g * dz;
#pragma unroll
      for (int q = 0; q < GPL; ++q)
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float t =
              dx * cur[0][q][c] + dy * cur[1][q][c] + dz * cur[2][q][c];
          y[0][q][c] += gx * t;
          y[1][q][c] += gy * t;
          y[2][q][c] += gz * t;
        }
      if (s + 1 < steps) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int q = 0; q < GPL; ++q)
#pragma unroll
            for (int c = 0; c < VEC; ++c) cur[a][q][c] = nxt[a][q][c];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < GPL; ++q)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        y[a][q][c] = springcraft::lane_sum(y[a][q][c], lpn);
  d00 = springcraft::lane_sum(d00, 1);
  d01 = springcraft::lane_sum(d01, 1);
  d02 = springcraft::lane_sum(d02, 1);
  d11 = springcraft::lane_sum(d11, 1);
  d12 = springcraft::lane_sum(d12, 1);
  d22 = springcraft::lane_sum(d22, 1);
  if (cols.ns != 0) return;  // lanes of neighbour 0 write the row
  float xi[3][GPL][VEC];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cols.load(x + a * plane + static_cast<size_t>(i) * k, xi[a]);
#pragma unroll
  for (int q = 0; q < GPL; ++q)
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float a0 = xi[0][q][c], a1 = xi[1][q][c], a2 = xi[2][q][c];
      y[0][q][c] -= d00 * a0 + d01 * a1 + d02 * a2;
      y[1][q][c] -= d01 * a0 + d11 * a1 + d12 * a2;
      y[2][q][c] -= d02 * a0 + d12 * a1 + d22 * a2;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cols.store(out + a * plane + static_cast<size_t>(i) * k, y[a]);
}

// One warp per row (kGatherWarps consecutive rows per block).
template <int VEC, int GPL>
__global__ void __launch_bounds__(springcraft::kGatherThreads)
    hessian_apply_pairs_kernel(const float* __restrict__ coords,
                               const int* __restrict__ row_ptr,
                               const int* __restrict__ slots,
                               const float* __restrict__ kvals,
                               const float* __restrict__ x,
                               float* __restrict__ out, int n, int k,
                               int lpn) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * springcraft::kGatherWarps + threadIdx.x / 32;
  if (i >= n) return;  // whole warp
  hessian_row<VEC, GPL>(i, springcraft::LaneColumns<VEC, GPL>(lane, lpn, k),
                        lane, lpn, coords, row_ptr, slots, kvals, x, out,
                        static_cast<size_t>(n) * k, k);
}

template <int VEC, int GPL>
void launch_pairs(dim3 grid, cudaStream_t stream, const float* coords,
                  const int* row_ptr, const int* slots, const float* kvals,
                  const float* x, float* out, int n, int k, int lpn) {
  hessian_apply_pairs_kernel<VEC, GPL>
      <<<grid, springcraft::kGatherThreads, 0, stream>>>(
          coords, row_ptr, slots, kvals, x, out, n, k, lpn);
}

using LaunchPairs = void (*)(dim3, cudaStream_t, const float*, const int*,
                             const int*, const float*, const float*, float*,
                             int, int, int);
// by [VEC == 4][GPL - 1]
constexpr LaunchPairs kLaunchPairs[2][4] = {
    {&launch_pairs<1, 1>, &launch_pairs<1, 2>, &launch_pairs<1, 3>,
     &launch_pairs<1, 4>},
    {&launch_pairs<4, 1>, &launch_pairs<4, 2>, &launch_pairs<4, 3>,
     &launch_pairs<4, 4>}};

// ---------------------------------------------------------------------------
// K12: the tile walk over every column atom
// ---------------------------------------------------------------------------

constexpr int kCols = 16;            // columns of X per block
constexpr int kAcc = 3 * kCols + 6;  // a lane's sums: y and D

template <bool kTable>
__global__ void __launch_bounds__(springcraft::kWalkThreads)
    hessian_apply_dense_kernel(const float* __restrict__ coords,
                               const float* __restrict__ x,
                               float* __restrict__ out, int n, int k,
                               int kind, float cutoff_sq, int has_cutoff,
                               springcraft::PairTable table,
                               const float* __restrict__ edges_sq,
                               const int* __restrict__ atom_code) {
  __shared__ springcraft::TileWalk<kTable> walk;
  __shared__ float partial[kWalkWarps - 1][kAcc][kWalkRows];
  walk.stage_edges(table, edges_sq);
  const int lane = threadIdx.x % kWalkRows, warp = threadIdx.x / kWalkRows;
  const int i = blockIdx.x * kWalkRows + lane;
  const bool active = i < n;
  const int c0 = blockIdx.y * kCols;
  const int kc = min(kCols, k - c0);

  springcraft::WalkRow row{0.0f, 0.0f, 0.0f, n, 0};
  if (active) {
    row = springcraft::WalkRow{coords[3 * i], coords[3 * i + 1],
                               coords[3 * i + 2], i,
                               kTable ? atom_code[i] : 0};
  }

  float y0[kCols], y1[kCols], y2[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) y0[c] = y1[c] = y2[c] = 0.0f;
  float d00 = 0.0f, d01 = 0.0f, d02 = 0.0f, d11 = 0.0f, d12 = 0.0f,
        d22 = 0.0f;
  const size_t plane = static_cast<size_t>(n) * k;

  walk.walk(coords, nullptr, atom_code, 0, n, n, row, active, kind,
            cutoff_sq, has_cutoff, table,
            [&](int j, float dx, float dy, float dz, float sq, float kij) {
              const float g = -__fdiv_rn(kij, sq == 0.0f ? 1.0f : sq);
              const float gx = g * dx, gy = g * dy, gz = g * dz;
              d00 += gx * dx;
              d01 += gx * dy;
              d02 += gx * dz;
              d11 += gy * dy;
              d12 += gy * dz;
              d22 += gz * dz;
              const float* xj = x + static_cast<size_t>(j) * k + c0;
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                if (c < kc) {
                  const float s = dx * __ldg(xj + c) +
                                  dy * __ldg(xj + plane + c) +
                                  dz * __ldg(xj + 2 * plane + c);
                  y0[c] += gx * s;
                  y1[c] += gy * s;
                  y2[c] += gz * s;
                }
              }
            });
  // warps 1.. hand their partial sums to warp 0
  if (warp > 0) {
    float(*mine)[kWalkRows] = partial[warp - 1];
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
  for (int w = 0; w < kWalkWarps - 1; ++w) {
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

// The pair CSR of matfree_pairs.cu: row_ptr (n + 1), slots and k (P).
extern "C" int sc_hessian_apply_pairs(const float* coords, const int* row_ptr,
                                      const int* slots, const float* kvals,
                                      const float* x, float* out, int n,
                                      int k, void* stream) {
  if (n > 0 && k > 0) {
    const springcraft::GatherShape s = springcraft::gather_shape(k, x, out);
    const dim3 grid(
        (n + springcraft::kGatherWarps - 1) / springcraft::kGatherWarps,
        (k + springcraft::kGatherCols - 1) / springcraft::kGatherCols);
    kLaunchPairs[s.vec == 4][s.gpl - 1](
        grid, static_cast<cudaStream_t>(stream), coords, row_ptr, slots,
        kvals, x, out, n, k, s.lpn);
  }
  return static_cast<int>(cudaGetLastError());
}

// tables (n_bins, 3, 20, 20), edges_sq (n_edges <= kMaxEdges) and atom_code
// (n) are read only for kind == table_compact and may be null otherwise.
extern "C" int sc_hessian_apply_dense(const float* coords, const float* x,
                                      float* out, int n, int k, int kind,
                                      float cutoff_sq, int has_cutoff,
                                      const float* tables,
                                      const float* edges_sq,
                                      const int* atom_code, int n_bins,
                                      int n_edges, void* stream) {
  if (n_edges > springcraft::kMaxEdges) return cudaErrorInvalidValue;
  if (n > 0 && k > 0) {
    const dim3 grid((n + kWalkRows - 1) / kWalkRows, (k + kCols - 1) / kCols);
    const auto kernel = kind == springcraft::kTableCompact
                            ? hessian_apply_dense_kernel<true>
                            : hessian_apply_dense_kernel<false>;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    kernel<<<grid, springcraft::kWalkThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        coords, x, out, n, k, kind, cutoff_sq, has_cutoff, table, edges_sq,
        atom_code);
  }
  return static_cast<int>(cudaGetLastError());
}
