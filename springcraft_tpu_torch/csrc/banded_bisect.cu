// All eigenvalues of a batch of symmetric band matrices by Sturm-count
// bisection.
//
// Replaces the TPU kernel springcraft_tpu/ops/spectrum.py:1132
// `_bisect_kernel` (reached through `banded_eigenvalues_pallas`, :1242, from
// `eigvalsh_banded` and `eigh_banded`).
//
// Eigenvalue j of matrix b starts in its Gershgorin interval [lo_b, hi_b]
// and is halved n_iter times: each halving counts the negative pivots of
// the LDL^t factorization of A_b - mid I (pivot floor 1e-30, only signs
// matter) and moves lo up to mid where the count is <= j, else hi down.  The
// result is the interval's midpoint.  The factorization runs the sliding
// W x W window of banded.cuh over the n columns, in float64: this
// elimination does not pivot, and in float32 its element growth flips pivot
// signs (a float32 count, the TPU kernel's arithmetic, put eigenvalues of
// N = 300 ANM Hessians up to 1.4e-3 of the largest away from float64 eigh;
// float64 counts over the same float32 band stay near 1e-7).  The band, the
// interval and the result stay float32.
//
// What bounds it on the H100: the float64 arithmetic of the window.  Each
// halving is n steps of one reciprocal, W - 1 multipliers and
// W (W - 1) / 2 multiply-subtracts; at (B, n) = (128, 900), W = 9 and 32
// halvings that is 3.3e9 steps, and the kernel reads nothing but the band.
//
// Design:
// - The window's step is fused (banded.cuh): fused multiply-adds,
//   about 50 float64 instructions a step instead of 100, and a Newton-
//   refined reciprocal; the loop over the rows is unrolled by four (on
//   the H100 faster than by two or not at all).  The counts may
//   then differ from the plain version's (ops/spectrum.py
//   `banded_bisect_plain`) only where a mid lies within the count's
//   backward error of an eigenvalue.
// - The block stages its matrix's feed in shared memory as float64 where
//   it fits (W (n + W) doubles: n <= 3,219 at W = 9; faster than a
//   float32 feed, which converts W values a step), else as float32
//   (n <= 6,447), else reads it from device memory through L1; every
//   thread of a warp reads the same word (a broadcast).
// - A shared tree for the first halvings: every eigenvalue of a matrix
//   starts from the same [lo, hi], so its first k halvings visit nodes of
//   one binary tree of mids, at most 2^(k - 1) distinct ones at depth k.  A
//   first kernel counts at the 2^t - 1 nodes of the first t = floor(log2 n)
//   levels (at most n at the last), one thread a node, into the wrapper's
//   scratch; the main kernel walks them from the root, bit for bit the
//   first t halvings, and counts from there.  At (128, 9, 900) that is 511
//   counts a matrix in place of 8,100.
// - An exact early stop: a halving is a function of (lo, hi) alone, and
//   its mid lies in [lo, hi], so lo never falls and hi never rises; once a
//   halving leaves the float32 pair unchanged, every later one repeats it
//   bit for bit (the same mid, the same count, the same update), and the
//   loop ends there with the bits the full n_iter halvings return.  The
//   lanes of a warp hold neighbouring eigenvalues, which reach float32
//   resolution within a halving or two of each other; the warp ends with
//   its last lane.
// - Multisection where one lane an eigenvalue leaves the card under-filled
//   (single structures): `levels` = k in 1..3 (the wrapper picks it from
//   B n and the SM count) gives each eigenvalue a group of 2^k - 1 lanes,
//   the nodes of the binary tree of its next k halvings in heap order; each
//   lane counts at its node's mid, the float32 expression 0.5 (lo + hi)
//   the sequential loop evaluates on that path, and the group walks the
//   tree with the counts (warp shuffles) and advances k halvings, bit for
//   bit as k single halvings.
// - Warps a block: 4 where the staged feed lets an SM hold three blocks;
//   where it holds fewer (single structures: one), up to 12, so that the
//   SM still runs 12 warps, but no more than spreading the launch over
//   every SM once needs.

#include <cuda_runtime.h>

#include <algorithm>

#include "banded.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxWarps = 12;
constexpr int kMaxLevels = 3;
constexpr double kTiny = 1e-30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// The mid of heap node `node` of the tree of the next halvings of
// [lo, hi]: the digits of node + 1 after its leading one are the path from
// the root, 1 where the eigenvalue lies above a mid (lo moves up).
__device__ __forceinline__ float node_mid(float lo, float hi, int node) {
  const int path = node + 1;
  for (int bit = 30 - __clz(path); bit >= 0; --bit) {
    const float mid = midpoint(lo, hi);
    if ((path >> bit) & 1) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return midpoint(lo, hi);
}

// Negative pivots of the LDL^t factorization of A - shift I.
template <int W, typename T>
__device__ __forceinline__ int sturm_count(const T* f, int stride, int n,
                                           double shift) {
  double u[banded::kSlots<W>];
  double l[W];
  banded::init_window<W>(u, f, stride, shift);
  int count = 0;
  // four steps an iteration, so the scheduler can start one step's
  // reciprocal while the last one's updates issue
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const double pivot = u[0];
    count += pivot < 0.0;
    banded::multipliers<W>(
        u, banded::inv_pivot(banded::clamp_pivot(pivot, kTiny)), l);
    banded::eliminate_append<W>(u, l, f, stride, i + W, shift);
  }
  return count;
}

// Sturm counts at the mids of the first `tree` levels of the halving tree
// of each matrix's [lo, hi], 2^tree - 1 nodes in heap order, one thread a
// node.
template <int W, typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bisect_tree_kernel(const float* __restrict__ feed,
                       const float* __restrict__ lo0,
                       const float* __restrict__ hi0,
                       int* __restrict__ counts, int n, int tree,
                       bool staged) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.y;
  const int stride = n + W;
  const T* f = banded::stage_feed<T>(
      feed + static_cast<size_t>(b) * W * stride,
      reinterpret_cast<T*>(smem), W * stride, staged);
  const int nodes = (1 << tree) - 1;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node < nodes)
    counts[static_cast<size_t>(b) * nodes + node] =
        sturm_count<W, T>(f, stride, n, node_mid(lo0[b], hi0[b], node));
}

template <int W, typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    banded_bisect_kernel(const float* __restrict__ feed,
                         const float* __restrict__ lo0,
                         const float* __restrict__ hi0,
                         const int* __restrict__ counts,
                         float* __restrict__ out, int n, int n_iter,
                         int levels, int tree, bool staged) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int b = blockIdx.y;
  const int stride = n + W;
  const T* f = banded::stage_feed<T>(
      feed + static_cast<size_t>(b) * W * stride,
      reinterpret_cast<T*>(smem), W * stride, staged);
  const int group = (1 << levels) - 1;
  const int per_warp = 32 / group;
  const int lane = threadIdx.x & 31;
  const int slot = lane / group;
  const int node = lane - slot * group;
  const int target =
      (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * per_warp + slot;
  const bool mine = slot < per_warp && target < n;

  // every lane of a group holds the same (lo, hi) and `active`
  bool active = mine;
  float lo = lo0[b], hi = hi0[b];
  // the first `tree` halvings from the shared counts
  const int* at_node = counts + static_cast<size_t>(b) * ((1 << tree) - 1);
  for (int d = 0, m = 0; d < tree; ++d) {
    const float mid = midpoint(lo, hi);
    if (at_node[m] <= target) {
      lo = mid;
      m = 2 * m + 2;
    } else {
      hi = mid;
      m = 2 * m + 1;
    }
  }
  for (int it = tree; it < n_iter && __any_sync(kFull, active);
       it += levels) {
    const int depth = min(levels, n_iter - it);
    int count = 0;
    if (active) count = sturm_count<W, T>(f, stride, n, node_mid(lo, hi, node));
    float a = lo, c = hi;
    for (int d = 0, m = 0; d < depth; ++d) {
      const int at = __shfl_sync(kFull, count, slot * group + m);
      const float mid = midpoint(a, c);
      if (at <= target) {
        a = mid;
        m = 2 * m + 2;
      } else {
        c = mid;
        m = 2 * m + 1;
      }
    }
    if (active) {
      active = __float_as_int(a) != __float_as_int(lo) ||
               __float_as_int(c) != __float_as_int(hi);
      lo = a;
      hi = c;
    }
  }
  if (mine && node == 0)
    out[static_cast<size_t>(b) * n + target] = midpoint(lo, hi);
}

// Warps a block for `warps` warps a matrix: 4 where the staged feed lets
// an SM hold three blocks; where it holds fewer, up to kMaxWarps, so that
// the SM still runs 12 warps, but no more than spreading every warp of the
// launch over the SMs once needs.
long long warps_per_block(int batch, long long warps, size_t smem, int sms,
                          int smem_per_sm) {
  // blocks an SM holds by the staged feed, with the 1 KB each reserves
  int per_sm = kMaxWarps / kWarps;
  if (smem)
    per_sm = std::min(per_sm, std::max(1, static_cast<int>(
                                              smem_per_sm / (smem + 1024))));
  const long long spread = static_cast<long long>(sms) * per_sm;
  return std::max(1LL, std::min<long long>(std::max(kWarps, kMaxWarps / per_sm),
                                           (batch * warps + spread - 1) /
                                               spread));
}

template <int W, typename T>
cudaError_t launch_as(const float* feed, const float* lo, const float* hi,
                      int* counts, float* out, int batch, int n, int n_iter,
                      int levels, bool staged, size_t smem,
                      cudaStream_t stream) {
  cudaError_t err = banded::allow_smem(bisect_tree_kernel<W, T>, smem);
  if (err == cudaSuccess)
    err = banded::allow_smem(banded_bisect_kernel<W, T>, smem);
  int device = 0, sms = 0, smem_per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  // the shared tree: floor(log2 n) levels, so that its last level has at
  // most n nodes (each saves one count of each of the n eigenvalues)
  int tree = 0;
  while (tree < n_iter && (2 << tree) <= n) ++tree;
  if (tree > 0) {
    const long long warps = ((1LL << tree) - 1 + 31) / 32;
    const long long wpb = warps_per_block(batch, warps, smem, sms,
                                          smem_per_sm);
    const dim3 grid(static_cast<unsigned>((warps + wpb - 1) / wpb), batch);
    bisect_tree_kernel<W, T>
        <<<grid, static_cast<unsigned>(32 * wpb), smem, stream>>>(
            feed, lo, hi, counts, n, tree, staged);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int per_warp = 32 / ((1 << levels) - 1);
  const long long warps = (n + per_warp - 1) / per_warp;  // a matrix
  const long long wpb = warps_per_block(batch, warps, smem, sms, smem_per_sm);
  const dim3 grid(static_cast<unsigned>((warps + wpb - 1) / wpb), batch);
  banded_bisect_kernel<W, T>
      <<<grid, static_cast<unsigned>(32 * wpb), smem, stream>>>(
          feed, lo, hi, counts, out, n, n_iter, levels, tree, staged);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(const float* feed, const float* lo, const float* hi,
                   int* counts, float* out, int batch, int n, int n_iter,
                   int levels, cudaStream_t stream) {
  banded::Feed form;
  size_t smem = 0;
  const cudaError_t err = banded::feed_form(W, n, 0, &form, &smem);
  if (err != cudaSuccess) return err;
  if (form == banded::Feed::kDouble)
    return launch_as<W, double>(feed, lo, hi, counts, out, batch, n, n_iter,
                                levels, true, smem, stream);
  return launch_as<W, float>(feed, lo, hi, counts, out, batch, n, n_iter,
                             levels, form == banded::Feed::kFloat, smem,
                             stream);
}

}  // namespace

extern "C" int sc_banded_bisect(const float* feed, const float* lo,
                                const float* hi, int* counts, float* out,
                                int batch, int n, int w, int n_iter,
                                int levels, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (levels < 1 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define SC_BISECT_CASE(W)                                                    \
  case W:                                                                    \
    return static_cast<int>(                                                 \
        launch<W>(feed, lo, hi, counts, out, batch, n, n_iter, levels, st));
  switch (w) {
    SC_BISECT_CASE(2)
    SC_BISECT_CASE(3)
    SC_BISECT_CASE(4)
    SC_BISECT_CASE(5)
    SC_BISECT_CASE(6)
    SC_BISECT_CASE(7)
    SC_BISECT_CASE(8)
    SC_BISECT_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SC_BISECT_CASE
}
