// Eigenvector estimates of a batch of symmetric band matrices by shifted
// LDL^t factorization and inverse iteration, one per shift.
//
// Replaces the TPU kernel springcraft_tpu/ops/spectrum.py:770
// `_eigvec_kernel` (reached through `_banded_eigenvectors_pallas`, :900,
// from `banded_eigenvectors` and `eigh_banded`).
//
// For shift s of matrix b: factor A_b - s I = L D L^t with the window of
// banded.cuh, pivots clamped in magnitude to the matrix's floor span_b * eps
// (an unclamped pivot near zero, with s at an eigenvalue, overflows L);
// then n_solves sweeps of forward substitution, division by D and backward
// substitution, from the start vector
// cos(0.7 i + seed + 2.347 idx + 0.9 i idx / n) + 1e-3 (idx the shift's
// global index, so a degenerate cluster's shifts start apart; the TPU
// kernel's start lacks the i idx term and spans only three dimensions,
// too few for the six rigid-body modes of an ANM Hessian — see
// ops/spectrum.py `_start_vector`), each later sweep from the last one
// normalized by its sum of squares.  The output is the last iterate,
// normalized, in float32.  The factorization and the sweeps run in double:
// the TPU kernel's float32 left about 0.5% of the vectors of N = 300 ANM
// Hessians with band residuals near 5e-4 ||B|| whatever the number of
// sweeps (element growth of the unpivoted factorization), a few of which the
// refinement downstream could not repair; in double every vector reaches
// about 1e-6 ||B||.
//
// What bounds it on the H100: the 1 + 2 n_solves dependent sweeps over n
// rows per shift, and the factors' traffic: a shift's L and D, W n doubles,
// do not fit in registers (7,200 at n = 900, W = 9).
//
// Design: one thread per (matrix, shift), 128 shifts of one matrix to a
// block; the TPU kernel laid the shifts along its 128 lanes and kept the
// factors in VMEM.  Here L, D and the iterate x live in device memory laid
// out shift-minor ([row][shift]), so a warp's 32 loads of one row fall on
// consecutive words; the caller bounds the scratch by launching chunks of
// shifts.  The feed is staged in shared memory as in banded_bisect.cu (or
// read from device memory past the per-block limit), the window and the
// substitution carries stay in registers.

#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

constexpr int kThreads = 128;

template <int W>
__global__ void banded_eigvec_kernel(
    const float* __restrict__ feed, const float* __restrict__ shifts,
    const float* __restrict__ pivot_floor, double* __restrict__ l_scratch,
    double* __restrict__ d_scratch, double* __restrict__ x_scratch,
    float* __restrict__ out, int n, int n_shifts, int idx0, int n_solves,
    double seed, bool staged) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int stride = n + W;
  const float* f = banded::stage_feed(
      feed + static_cast<size_t>(b) * W * stride, smem, W * stride, staged);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_shifts) return;

  const size_t ld = n_shifts;  // row stride of the shift-minor arrays
  double* lmat = l_scratch + static_cast<size_t>(b) * (W - 1) * n * ld + s;
  double* dvec = d_scratch + static_cast<size_t>(b) * n * ld + s;
  double* x = x_scratch + static_cast<size_t>(b) * n * ld + s;
  float* y = out + static_cast<size_t>(b) * n * ld + s;
  const double shift = shifts[static_cast<size_t>(b) * n_shifts + s];
  const double floor = pivot_floor[b];

  // ---- factorization: lmat[(p - 1) n + i] = L[i + p, i], dvec[i] = D[i]
  {
    double u[banded::kSlots<W>];
    double l[W];
    banded::init_window<W>(u, f, stride, shift);
    for (int i = 0; i < n; ++i) {
      const double safe = banded::clamp_pivot(u[0], floor);
      dvec[i * ld] = safe;
      banded::multipliers<W>(u, 1.0 / safe, l);
#pragma unroll
      for (int p = 1; p < W; ++p) lmat[((p - 1) * n + i) * ld] = l[p];
      banded::eliminate_append<W>(u, l, f, stride, i + W, shift);
    }
  }

  // ---- inverse iteration
  const double idx = static_cast<double>(idx0 + s);
  const double fn = static_cast<double>(n);
  double inv_norm = 1.0;
  for (int it = 0; it < n_solves; ++it) {
    // forward: z_i = rhs_i - acc[0]; acc carries the later rows' terms
    double acc[W - 1];
#pragma unroll
    for (int p = 0; p < W - 1; ++p) acc[p] = 0.0;
    for (int i = 0; i < n; ++i) {
      double rhs;
      if (it == 0) {
        const double fi = static_cast<double>(i);
        const double phase = __dadd_rn(
            __dadd_rn(__dadd_rn(__dmul_rn(0.7, fi), seed),
                      __dmul_rn(2.347, idx)),
            __ddiv_rn(__dmul_rn(0.9, __dmul_rn(fi, idx)), fn));
        rhs = __dadd_rn(cos(phase), 1e-3);
      } else {
        rhs = __dmul_rn(x[i * ld], inv_norm);
      }
      const double z = __dsub_rn(rhs, acc[0]);
#pragma unroll
      for (int p = 0; p < W - 2; ++p) acc[p] = acc[p + 1];
      acc[W - 2] = 0.0;
#pragma unroll
      for (int p = 0; p < W - 1; ++p)
        acc[p] = __dadd_rn(acc[p], __dmul_rn(lmat[(p * n + i) * ld], z));
      x[i * ld] = z;
    }
    // diagonal and backward: x_i = z_i / d_i - sum_p L[i + 1 + p, i] x_{i+1+p}
    double xwin[W - 1];
#pragma unroll
    for (int p = 0; p < W - 1; ++p) xwin[p] = 0.0;
    double sumsq = 0.0;
    for (int i = n - 1; i >= 0; --i) {
      double dot = 0.0;
#pragma unroll
      for (int p = 0; p < W - 1; ++p)
        dot = __dadd_rn(dot, __dmul_rn(lmat[(p * n + i) * ld], xwin[p]));
      const double xi = __dsub_rn(__ddiv_rn(x[i * ld], dvec[i * ld]), dot);
      x[i * ld] = xi;
#pragma unroll
      for (int p = W - 2; p > 0; --p) xwin[p] = xwin[p - 1];
      xwin[0] = xi;
      sumsq = __dadd_rn(sumsq, __dmul_rn(xi, xi));
    }
    inv_norm = __ddiv_rn(1.0, __dsqrt_rn(fmax(sumsq, 1e-30)));
  }
  for (int i = 0; i < n; ++i)
    y[i * ld] = static_cast<float>(__dmul_rn(x[i * ld], inv_norm));
}

template <int W>
cudaError_t launch(const float* feed, const float* shifts,
                   const float* pivot_floor, double* l_scratch,
                   double* d_scratch, double* x_scratch, float* out,
                   int batch, int n, int n_shifts, int idx0, int n_solves,
                   double seed, cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t err =
      banded::feed_smem(banded_eigvec_kernel<W>,
                        sizeof(float) * W * static_cast<size_t>(n + W), &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_shifts + kThreads - 1) / kThreads, batch);
  banded_eigvec_kernel<W><<<grid, kThreads, smem, stream>>>(
      feed, shifts, pivot_floor, l_scratch, d_scratch, x_scratch, out, n,
      n_shifts, idx0, n_solves, seed, smem != 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sc_banded_eigvec(const float* feed, const float* shifts,
                                const float* pivot_floor, double* l_scratch,
                                double* d_scratch, double* x_scratch,
                                float* out, int batch, int n, int w,
                                int n_shifts, int idx0, int n_solves,
                                double seed, void* stream) {
  if (batch <= 0 || n <= 0 || n_shifts <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define SC_EIGVEC_CASE(W)                                                  \
  case W:                                                                  \
    return static_cast<int>(launch<W>(feed, shifts, pivot_floor, l_scratch, \
                                      d_scratch, x_scratch, out, batch, n, \
                                      n_shifts, idx0, n_solves, seed, st));
  switch (w) {
    SC_EIGVEC_CASE(2)
    SC_EIGVEC_CASE(3)
    SC_EIGVEC_CASE(4)
    SC_EIGVEC_CASE(5)
    SC_EIGVEC_CASE(6)
    SC_EIGVEC_CASE(7)
    SC_EIGVEC_CASE(8)
    SC_EIGVEC_CASE(9)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SC_EIGVEC_CASE
}
