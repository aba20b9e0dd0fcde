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
// What bounds it on the H100: the dependent float64 arithmetic of the
// window.  Each halving is n steps of one reciprocal and W (W - 1) / 2 +
// W - 1 multiply-subtracts that depend on the step before; at (B, n) =
// (128, 900), W = 9 and 32 halvings a thread runs 28,800 such steps and
// reads nothing but the band from memory.
//
// Design: one thread per (matrix, eigenvalue) — the TPU kernel laid the
// eigenvalues along its vector lanes — 128 threads of one matrix to a block.
// The window (45 doubles at W = 9), the interval and the count stay in
// registers through all halvings, in one launch.  The block stages its
// matrix's feed, W (n + W) floats (32.7 KB at n = 900), in shared memory,
// where every thread of a warp reads the same word (a broadcast); past the
// device's per-block limit (227 KB: n > 6447 at W = 9) it reads the feed
// from device memory through L1 instead.  A block of 128 threads at n = 900
// leaves the card less than half full (115,200 threads at B = 128).

#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

constexpr int kThreads = 128;
constexpr double kTiny = 1e-30;

template <int W>
__global__ void banded_bisect_kernel(const float* __restrict__ feed,
                                     const float* __restrict__ lo0,
                                     const float* __restrict__ hi0,
                                     float* __restrict__ out, int n,
                                     int n_iter, bool staged) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int stride = n + W;
  const float* f = banded::stage_feed(
      feed + static_cast<size_t>(b) * W * stride, smem, W * stride, staged);
  const int target = blockIdx.x * kThreads + threadIdx.x;
  if (target >= n) return;

  float lo = lo0[b], hi = hi0[b];
  for (int it = 0; it < n_iter; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const double shift = mid;
    double u[banded::kSlots<W>];
    double l[W];
    banded::init_window<W>(u, f, stride, shift);
    int count = 0;
    for (int i = 0; i < n; ++i) {
      const double pivot = u[0];
      count += pivot < 0.0;
      banded::multipliers<W>(
          u, 1.0 / banded::clamp_pivot(pivot, kTiny), l);
      banded::eliminate_append<W>(u, l, f, stride, i + W, shift);
    }
    if (count <= target) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  out[static_cast<size_t>(b) * n + target] =
      __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

template <int W>
cudaError_t launch(const float* feed, const float* lo, const float* hi,
                   float* out, int batch, int n, int n_iter,
                   cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err =
      banded::feed_smem(banded_bisect_kernel<W>,
                        sizeof(float) * W * static_cast<size_t>(n + W), &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  banded_bisect_kernel<W><<<grid, kThreads, smem, stream>>>(
      feed, lo, hi, out, n, n_iter, smem != 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sc_banded_bisect(const float* feed, const float* lo,
                                const float* hi, float* out, int batch, int n,
                                int w, int n_iter, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define SC_BISECT_CASE(W) \
  case W:                 \
    return static_cast<int>(launch<W>(feed, lo, hi, out, batch, n, n_iter, st));
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
