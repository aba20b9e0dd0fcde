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
// What bounds it on the H100: a shift's factors, W n doubles (7,200 at
// n = 900, W = 9), fit neither in registers nor, for a block of shifts, in
// shared memory; written to device memory and read back by every sweep
// they made 51.5 n doubles of traffic a shift (42.7 GB a call at
// (128, 900)).  Recomputing a row of the factors (about 50 float64
// instructions) costs less than reading it back (W doubles).  Past the
// traffic, the dependent chain of a step (the pivot's reciprocal, then the
// next pivot) bounds a thread, and registers (about 200 a thread) bound
// how many threads hide it.
//
// Design: one thread per (matrix, shift), kThreads shifts of one matrix to
// a block (the TPU kernel laid the shifts along its 128 lanes and kept the
// factors in VMEM); the factors never reach device memory.
// - Each forward sweep runs the factorization alongside it from the top of
//   the band, the first one from the closed-form start vector; the first
//   also saves the window at the first row of each segment of kSegment
//   rows: its W (W - 1) / 2 eliminated entries (36 doubles at W = 9), as
//   its last column is the band's own, read again from the feed.
// - Each backward sweep walks the segments from the last: it reloads the
//   segment's window, refactors its rows into shared memory (1 / d and the
//   W - 1 multipliers of each row, [row][W][thread], so that a warp's
//   words are consecutive) and substitutes backward through them, the
//   older rows' terms first so that only one fused multiply-add waits for
//   the row before.  The factorization is the same deterministic
//   recurrence each time, so every sweep sees the same L and D bit for bit.
// - The step is banded.cuh's fused one, as in the bisection: the vectors
//   differ from the plain version's (ops/spectrum.py `banded_eigvec_plain`,
//   separately rounded, correctly rounded division) by the elimination's
//   backward error times their condition, and are held to it by their
//   residuals and overlaps.
// - Device memory holds only the checkpoints (written once, read by each
//   backward sweep), the iterate (one double a row, read and rewritten by
//   each sweep) and the float32 output: about 22 n doubles a shift at
//   n = 900 (18 GB a call at (128, 900) instead of 42.7).  Laid out
//   shift-minor ([.][shift]), a warp's 32 words of one row are
//   consecutive.  The backward sweep loads a segment's iterate before it
//   refactors the segment, and asks L2 for the next segment's checkpoint
//   and iterate, so their latency hides behind the arithmetic.
// - kThreads = 256 with kSegment = 8: the segment store, 147 KB at W = 9,
//   and the registers let an SM run eight warps, two a scheduler (on the
//   H100 faster at (128, 900) than 128 threads with 16-row segments, four
//   warps, despite their 30% less traffic, and than 4-row segments).
// - The block stages its matrix's feed in shared memory beside the segment
//   store, as float64 where both fit under the per-block limit (n <= 1,095
//   at W = 9), else float32 (n <= 2,190), else reads it from device memory
//   through L1.

#include <cuda_runtime.h>

#include "banded.cuh"

namespace {

constexpr int kThreads = 256;  // shifts a block
constexpr int kSegment = 8;    // rows between checkpoints

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Row i of the start vector of the shift with global index `idx`.
__device__ __forceinline__ double start_value(int i, double idx, double seed,
                                              double fn) {
  const double fi = static_cast<double>(i);
  const double phase = __dadd_rn(
      __dadd_rn(__dadd_rn(__dmul_rn(0.7, fi), seed), __dmul_rn(2.347, idx)),
      __ddiv_rn(__dmul_rn(0.9, __dmul_rn(fi, idx)), fn));
  return __dadd_rn(cos(phase), 1e-3);
}

template <int W, typename T>
__global__ void __launch_bounds__(kThreads) banded_eigvec_kernel(
    const float* __restrict__ feed, const float* __restrict__ shifts,
    const float* __restrict__ pivot_floor, double* __restrict__ checkpoints,
    double* __restrict__ x_scratch, float* __restrict__ out, int n,
    int n_shifts, int idx0, int n_solves, double seed, bool staged) {
  constexpr int kSlots = banded::kSlots<W>;
  constexpr int kHeld = kSlots - W;  // a checkpoint: all but the last column
  extern __shared__ __align__(8) unsigned char smem[];
  double* segment = reinterpret_cast<double*>(smem);
  const int b = blockIdx.y;
  const int stride = n + W;
  const T* f = banded::stage_feed<T>(
      feed + static_cast<size_t>(b) * W * stride,
      reinterpret_cast<T*>(segment + kSegment * W * kThreads), W * stride,
      staged);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_shifts) return;

  const size_t ld = n_shifts;  // row stride of the shift-minor arrays
  const int n_seg = (n + kSegment - 1) / kSegment;
  double* ck = checkpoints + static_cast<size_t>(b) * n_seg * kHeld * ld + s;
  double* x = x_scratch + static_cast<size_t>(b) * n * ld + s;
  float* y = out + static_cast<size_t>(b) * n * ld + s;
  double* mine = segment + threadIdx.x;  // [row][p][thread], p 0 is d
  const double shift = shifts[static_cast<size_t>(b) * n_shifts + s];
  const double floor = pivot_floor[b];
  const double idx = static_cast<double>(idx0 + s);
  const double fn = static_cast<double>(n);

  double inv_norm = 1.0;
  for (int it = 0; it < n_solves; ++it) {
    // forward: z_i = rhs_i - acc[0]; acc carries the later rows' terms; the
    // factorization runs alongside
    {
      double u[kSlots];
      double l[W];
      double acc[W - 1];
#pragma unroll
      for (int p = 0; p < W - 1; ++p) acc[p] = 0.0;
      banded::init_window<W>(u, f, stride, shift);
      double next = it == 0 ? 0.0 : x[0];
      for (int i = 0; i < n; ++i) {
        double rhs;
        if (it == 0) {
          if (i % kSegment == 0) {
            double* c = ck + static_cast<size_t>(i / kSegment) * kHeld * ld;
#pragma unroll
            for (int k = 0; k < kHeld; ++k) c[k * ld] = u[k];
          }
          rhs = start_value(i, idx, seed, fn);
        } else {
          rhs = __dmul_rn(next, inv_norm);
          if (i + 1 < n) next = x[(i + 1) * ld];
          if (i + 8 < n) prefetch_l2(x + (i + 8) * ld);
        }
        banded::multipliers<W>(
            u, banded::inv_pivot(banded::clamp_pivot(u[0], floor)), l);
        const double z = __dsub_rn(rhs, acc[0]);
#pragma unroll
        for (int p = 0; p < W - 2; ++p) acc[p] = fma(l[p + 1], z, acc[p + 1]);
        acc[W - 2] = __dmul_rn(l[W - 1], z);
        x[i * ld] = z;
        banded::eliminate_append<W>(u, l, f, stride, i + W, shift);
      }
    }
    // diagonal and backward: x_i = z_i / d_i - sum_p L[i + 1 + p, i]
    // x_{i+1+p}, segment by segment from the last
    double xwin[W - 1];
#pragma unroll
    for (int p = 0; p < W - 1; ++p) xwin[p] = 0.0;
    double sumsq = 0.0;
    for (int sg = n_seg - 1; sg >= 0; --sg) {
      const int r0 = sg * kSegment;
      const int rows = min(kSegment, n - r0);
      double z[kSegment];
#pragma unroll
      for (int r = 0; r < kSegment; ++r)
        if (r < rows) z[r] = x[(r0 + r) * ld];
      if (sg > 0) {
        const double* c = ck + static_cast<size_t>(sg - 1) * kHeld * ld;
#pragma unroll
        for (int k = 0; k < kHeld; ++k) prefetch_l2(c + k * ld);
#pragma unroll
        for (int r = 0; r < kSegment; ++r)
          prefetch_l2(x + (r0 - kSegment + r) * ld);
      }
      {
        double u[kSlots];
        double l[W];
        const double* c = ck + static_cast<size_t>(sg) * kHeld * ld;
#pragma unroll
        for (int k = 0; k < kHeld; ++k) u[k] = c[k * ld];
        banded::load_last_column<W>(u, f, stride, r0 + W - 1, shift);
        for (int r = 0; r < rows; ++r) {
          const double inv =
              banded::inv_pivot(banded::clamp_pivot(u[0], floor));
          banded::multipliers<W>(u, inv, l);
          double* row = mine + r * W * kThreads;
          row[0] = inv;
#pragma unroll
          for (int p = 1; p < W; ++p) row[p * kThreads] = l[p];
          banded::eliminate_append<W>(u, l, f, stride, r0 + r + W,
                                            shift);
        }
      }
      // the older rows' terms first, so that only the last fused
      // multiply-add waits for x_{i+1}
#pragma unroll
      for (int r = kSegment - 1; r >= 0; --r) {
        if (r >= rows) continue;
        const double* row = mine + r * W * kThreads;
        double rest = __dmul_rn(z[r], row[0]);
#pragma unroll
        for (int p = W - 2; p > 0; --p)
          rest = fma(-row[(p + 1) * kThreads], xwin[p], rest);
        const double xi = fma(-row[kThreads], xwin[0], rest);
        x[(r0 + r) * ld] = xi;
#pragma unroll
        for (int p = W - 2; p > 0; --p) xwin[p] = xwin[p - 1];
        xwin[0] = xi;
        sumsq = fma(xi, xi, sumsq);
      }
    }
    inv_norm = __ddiv_rn(1.0, __dsqrt_rn(fmax(sumsq, 1e-30)));
  }
  for (int i = 0; i < n; ++i)
    y[i * ld] = static_cast<float>(__dmul_rn(x[i * ld], inv_norm));
}

template <int W, typename T>
cudaError_t launch_as(const float* feed, const float* shifts,
                      const float* pivot_floor, double* checkpoints,
                      double* x_scratch, float* out, int batch, int n,
                      int n_shifts, int idx0, int n_solves, double seed,
                      bool staged, size_t smem, cudaStream_t stream) {
  const cudaError_t err =
      banded::allow_smem(banded_eigvec_kernel<W, T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_shifts + kThreads - 1) / kThreads, batch);
  banded_eigvec_kernel<W, T><<<grid, kThreads, smem, stream>>>(
      feed, shifts, pivot_floor, checkpoints, x_scratch, out, n, n_shifts,
      idx0, n_solves, seed, staged);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(const float* feed, const float* shifts,
                   const float* pivot_floor, double* checkpoints,
                   long long checkpoint_len, double* x_scratch, float* out,
                   int batch, int n, int n_shifts, int idx0, int n_solves,
                   double seed, cudaStream_t stream) {
  // the caller's checkpoint buffer holds this many doubles a (matrix, shift)
  const long long needed =
      static_cast<long long>((n + kSegment - 1) / kSegment) * W * (W - 1) / 2;
  if (checkpoint_len < needed) return cudaErrorInvalidValue;
  banded::Feed form;
  size_t smem = 0;
  const cudaError_t err = banded::feed_form(
      W, n, sizeof(double) * kSegment * W * kThreads, &form, &smem);
  if (err != cudaSuccess) return err;
  if (form == banded::Feed::kDouble)
    return launch_as<W, double>(feed, shifts, pivot_floor, checkpoints,
                                x_scratch, out, batch, n, n_shifts, idx0,
                                n_solves, seed, true, smem, stream);
  return launch_as<W, float>(feed, shifts, pivot_floor, checkpoints,
                             x_scratch, out, batch, n, n_shifts, idx0,
                             n_solves, seed, form == banded::Feed::kFloat,
                             smem, stream);
}

}  // namespace

extern "C" int sc_banded_eigvec(const float* feed, const float* shifts,
                                const float* pivot_floor, double* checkpoints,
                                long long checkpoint_len, double* x_scratch,
                                float* out, int batch, int n, int w,
                                int n_shifts, int idx0, int n_solves,
                                double seed, void* stream) {
  if (batch <= 0 || n <= 0 || n_shifts <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
#define SC_EIGVEC_CASE(W)                                                     \
  case W:                                                                     \
    return static_cast<int>(launch<W>(                                        \
        feed, shifts, pivot_floor, checkpoints, checkpoint_len, x_scratch,    \
        out, batch, n, n_shifts, idx0, n_solves, seed, st));
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
