// Matrix-free GNM Kirchhoff apply, Y = K X, without the Kirchhoff matrix:
// X (n, k) to Y (n, k),
//
//   y_i = -sum_j k_ij x_j + (sum_j k_ij) x_i,
//
// over the pair CSR that matfree_pairs.cu builds once per set-up (row_ptr,
// slot j and k_ij of every ordered pair within the cutoff, Morton order).
//
// Replaces the TPU kernel springcraft_tpu/ops/matfree.py:964
// `_sparse_kirchhoff_kernel` (K14, reached through
// `kirchhoff_apply_pallas_sparse`), which multiplied the whole (T, T)
// constant plane of every neighbour tile pair on its MXU, under 1% of it
// within the cutoff.  Walking those tile pairs on every apply bound the
// first port of this kernel by its instruction rate; over the list the
// work is one FMA per gathered float, so the bound is the P x k x 4 bytes
// of x_j rows read from L2 (X is 4 n k bytes and stays there).
//
// Design (pair_gather.cuh): a warp per row and up to 64 columns, lanes on
// (neighbour, float4 column group); each lane reads one pair of a batch of
// 32 (slot and constant, coalesced) and the lanes of a step take theirs by
// __shfl_sync; the next step's x_j rows are in flight during this step's
// FMAs; the degree is summed per lane and `+ deg_i x_i` comes last; each
// output row is written once, no atomics, and no table branch (the
// constant is in the list).

#include <cuda_runtime.h>

#include "pair_gather.cuh"

namespace {

using springcraft::kFullMask;

// Row i of Y for this warp's lane columns.
template <int VEC, int GPL>
__device__ __forceinline__ void kirchhoff_row(
    int i, const springcraft::LaneColumns<VEC, GPL>& cols, int lane,
    int lpn, const int* __restrict__ row_ptr, const int* __restrict__ slots,
    const float* __restrict__ kvals, const float* __restrict__ x,
    float* __restrict__ out, int k) {
  float y[GPL][VEC];
#pragma unroll
  for (int q = 0; q < GPL; ++q)
#pragma unroll
    for (int c = 0; c < VEC; ++c) y[q][c] = 0.0f;
  float deg = 0.0f;  // over the pairs this lane read

  const int p1 = row_ptr[i + 1];
  for (int base = row_ptr[i]; base < p1; base += 32) {
    // this lane's pair of the batch; a lane past the end reads row i with
    // k = 0
    int mj = i;
    float mk = 0.0f;
    if (base + lane < p1) {
      mj = slots[base + lane];
      mk = kvals[base + lane];
      deg += mk;
    }
    const int steps = (min(32, p1 - base) + cols.npw - 1) / cols.npw;
    float cur[GPL][VEC], nxt[GPL][VEC];
    int src = cols.ns;
    cols.load(x + static_cast<size_t>(__shfl_sync(kFullMask, mj, src)) * k,
              cur);
    for (int s = 0; s < steps; ++s) {
      const float kij = __shfl_sync(kFullMask, mk, src);
      src += cols.npw;
      if (s + 1 < steps)
        cols.load(
            x + static_cast<size_t>(__shfl_sync(kFullMask, mj, src)) * k,
            nxt);
#pragma unroll
      for (int q = 0; q < GPL; ++q)
#pragma unroll
        for (int c = 0; c < VEC; ++c) y[q][c] -= kij * cur[q][c];
      if (s + 1 < steps) {
#pragma unroll
        for (int q = 0; q < GPL; ++q)
#pragma unroll
          for (int c = 0; c < VEC; ++c) cur[q][c] = nxt[q][c];
      }
    }
  }

#pragma unroll
  for (int q = 0; q < GPL; ++q)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      y[q][c] = springcraft::lane_sum(y[q][c], lpn);
  deg = springcraft::lane_sum(deg, 1);
  if (cols.ns != 0) return;  // lanes of neighbour 0 write the row
  float xi[GPL][VEC];
  cols.load(x + static_cast<size_t>(i) * k, xi);
#pragma unroll
  for (int q = 0; q < GPL; ++q)
#pragma unroll
    for (int c = 0; c < VEC; ++c) y[q][c] += deg * xi[q][c];
  cols.store(out + static_cast<size_t>(i) * k, y);
}

// One warp per row (kGatherWarps consecutive rows per block).
template <int VEC, int GPL>
__global__ void __launch_bounds__(springcraft::kGatherThreads)
    kirchhoff_apply_pairs_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ slots,
                                 const float* __restrict__ kvals,
                                 const float* __restrict__ x,
                                 float* __restrict__ out, int n, int k,
                                 int lpn) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * springcraft::kGatherWarps + threadIdx.x / 32;
  if (i >= n) return;  // whole warp
  kirchhoff_row<VEC, GPL>(i, springcraft::LaneColumns<VEC, GPL>(lane, lpn, k),
                          lane, lpn, row_ptr, slots, kvals, x, out, k);
}

template <int VEC, int GPL>
void launch_pairs(dim3 grid, cudaStream_t stream, const int* row_ptr,
                  const int* slots, const float* kvals, const float* x,
                  float* out, int n, int k, int lpn) {
  kirchhoff_apply_pairs_kernel<VEC, GPL>
      <<<grid, springcraft::kGatherThreads, 0, stream>>>(
          row_ptr, slots, kvals, x, out, n, k, lpn);
}

using LaunchPairs = void (*)(dim3, cudaStream_t, const int*, const int*,
                             const float*, const float*, float*, int, int,
                             int);
// by [VEC == 4][GPL - 1]
constexpr LaunchPairs kLaunchPairs[2][4] = {
    {&launch_pairs<1, 1>, &launch_pairs<1, 2>, &launch_pairs<1, 3>,
     &launch_pairs<1, 4>},
    {&launch_pairs<4, 1>, &launch_pairs<4, 2>, &launch_pairs<4, 3>,
     &launch_pairs<4, 4>}};

}  // namespace

// The pair CSR of matfree_pairs.cu: row_ptr (n + 1), slots and k (P).
extern "C" int sc_kirchhoff_apply_pairs(const int* row_ptr, const int* slots,
                                        const float* kvals, const float* x,
                                        float* out, int n, int k,
                                        void* stream) {
  if (n > 0 && k > 0) {
    const springcraft::GatherShape s = springcraft::gather_shape(k, x, out);
    const dim3 grid(
        (n + springcraft::kGatherWarps - 1) / springcraft::kGatherWarps,
        (k + springcraft::kGatherCols - 1) / springcraft::kGatherCols);
    kLaunchPairs[s.vec == 4][s.gpl - 1](grid,
                                        static_cast<cudaStream_t>(stream),
                                        row_ptr, slots, kvals, x, out, n, k,
                                        s.lpn);
  }
  return static_cast<int>(cudaGetLastError());
}
