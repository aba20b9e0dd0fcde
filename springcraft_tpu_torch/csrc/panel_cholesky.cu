// Lower Cholesky factor L of small SPD panels, (P, pb, pb) -> (P, pb, pb)
// with the strict upper triangle written as zero.
//
// Replaces the TPU kernel springcraft_tpu/ops/pallas_linalg.py:58
// `_panel_kernel` (reached through `panel_cholesky_batched`, which then
// inverts L by Newton products outside the kernel and masks the upper
// triangle; here the kernel writes the zeros itself).
//
// Step i takes rs = 1 / sqrt(M[i, i]), scales column i from the diagonal
// down by rs — that column is then L's — and subtracts its outer product
// from the trailing lower triangle.  There is no pivot clamp: a
// non-positive pivot gives inf/NaN in the output, which is how the caller
// detects a panel that is not SPD.  Only the lower triangle of the input
// reaches the output.
//
// What bounds it on the H100: latency.  A panel is pb dependent steps of at
// most pb^2 / 2 multiply-subtracts; the panel's bytes (32 KB read and
// written at pb = 64) take microseconds, and the main path's 128 panels
// give one block to most SMs and nothing to hide a step's latency.
//
// Its design: the left half of the shrink elimination of panel_inverse.cu,
// on the transposed lower triangle.  State row r is column r of the lower
// triangle (M[c, r], c >= r), so step i's pivot row, scaled by rs, is L's
// column i, and every row r > i takes the same rank-1 update from it,
// row[r, c] -= l[c] l[r]: the coefficient of a row is the pivot row's own
// slot r.  The state lives in registers with fixed ownership: warp w owns
// the R = 8 consecutive rows w R .. w R + R - 1, and lane t holds slots
// t C .. t C + C - 1 of each of them (C = 1, 2 or 4 up to pb 32, 64,
// 128), so a warp's pivot row is already spread over its lanes and needs
// no gather.  Warp k runs the steps of its own R pivots alone (the pivot
// and the coefficients of its own rows by shuffles), and publishes each
// scaled pivot row to shared memory; the warps below apply each step as
// soon as it is published, meeting warp k on a named barrier per step
// (none block-wide), a row's coefficients read as one broadcast from the
// published row.  Rows above the pivot are final and do no work.  The
// steps of a block are unrolled (the blocks too up to pb 64), so a step's
// registers are known at compile time; each pb is its own instance.
// Every element sees the same __fmul_rn / __fsub_rn sequence, and each
// pivot the same IEEE square root and reciprocal, as in the plain
// version, so the output equals it bit for bit.  A thread's four
// consecutive rows of one slot are four consecutive floats of one row of
// the panel (M[c, 4h .. 4h + 3]), so the panel moves in 16-byte loads and
// stores, and the panels must start on a 16-byte boundary (the wrapper
// checks).

#include <cuda_runtime.h>

#include "vector_io.cuh"

namespace {

// Rows a warp: 8, so a warp's block of steps takes 8 named barriers (4
// rows a warp, and one warp a whole panel at pb 64, were slower).
constexpr int kRowsPerWarp = 8;
// Panels up to this size unroll the loop over blocks of steps as well
// (faster at 64; at 128 the unrolled code was slower).
constexpr int kUnrolledPanel = 64;

template <int PB>
struct CholeskyLayout {
  static constexpr int kRows = kRowsPerWarp;
  // slots a lane: 1, 2 or 4, so that kCols divides kRows and a step's
  // registers stay known at compile time within a block of steps
  static constexpr int kCols = PB <= 32 ? 1 : PB <= 64 ? 2 : 4;
  static constexpr int kWarps = PB / kRows;
  static constexpr int kThreads = 32 * kWarps;
  static_assert(kRows % 4 == 0 && PB % kRows == 0 && kRows % kCols == 0,
                "rows in fours");
  static_assert(kRows < 16, "one named barrier a step");
};

// Block k of the elimination, in thread (warp w, slots from c0) of the
// kernel below: the steps i = k R + j of warp k's pivots.  Step j of every
// block meets on named barrier 1 + j: warp k arrives when it has published
// the step, the W - k - 1 warps below wait for it.  Two buffers suffice: a
// warp writes block k + 2 only after it has waited for every warp below at
// each step of block k + 1, so none of them still reads block k.
template <int PB>
__device__ __forceinline__ void block_steps(
    int k, int w, int c0,
    float (&v)[CholeskyLayout<PB>::kRows][CholeskyLayout<PB>::kCols],
    float (*s_row)[CholeskyLayout<PB>::kRows]
                  [32 * CholeskyLayout<PB>::kCols]) {
  constexpr int R = CholeskyLayout<PB>::kRows;
  constexpr int C = CholeskyLayout<PB>::kCols;
  constexpr int W = CholeskyLayout<PB>::kWarps;
  constexpr unsigned kAll = 0xffffffffu;
  const int buf = k & 1;
  const int waiting = 32 * (W - k);
  if (w == k) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = k * R + j;
      const float rs =
          __frcp_rn(__fsqrt_rn(__shfl_sync(kAll, v[j][j % C], i / C)));
      float l[C];
#pragma unroll
      for (int q = 0; q < C; ++q) l[q] = v[j][q] = __fmul_rn(v[j][q], rs);
      if (k + 1 < W) {
        store_floats(&s_row[buf][j][c0], l);
        asm volatile("bar.arrive %0, %1;" ::"r"(1 + j), "r"(waiting)
                     : "memory");
      }
      // this warp's rows below the pivot
#pragma unroll
      for (int g = j + 1; g < R; ++g) {
        const int r = k * R + g;
        const float coef = __shfl_sync(kAll, l[g % C], r / C);
#pragma unroll
        for (int q = 0; q < C; ++q)
          v[g][q] = __fsub_rn(v[g][q], __fmul_rn(l[q], coef));
      }
    }
  } else if (w > k) {
    // the rows below apply each step as soon as it is published
#pragma unroll
    for (int j = 0; j < R; ++j) {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + j), "r"(waiting)
                   : "memory");
      float l[C], coef[R];
      load_floats(l, &s_row[buf][j][c0]);
      load_floats(coef, &s_row[buf][j][w * R]);
#pragma unroll
      for (int g = 0; g < R; ++g)
#pragma unroll
        for (int q = 0; q < C; ++q)
          v[g][q] = __fsub_rn(v[g][q], __fmul_rn(l[q], coef[g]));
    }
  }
}

// One block per panel, CholeskyLayout<PB>::kThreads threads: lane t of
// warp w holds slots t C .. t C + C - 1 (those below pb) of rows
// w R .. w R + R - 1; v[g][q] is M[t C + q, w R + g].
template <int PB>
__global__ void __launch_bounds__(CholeskyLayout<PB>::kThreads)
    panel_cholesky_kernel(const float* __restrict__ panels,
                          float* __restrict__ out) {
  constexpr int R = CholeskyLayout<PB>::kRows;
  constexpr int C = CholeskyLayout<PB>::kCols;
  constexpr int W = CholeskyLayout<PB>::kWarps;
  // double-buffered by block of steps: the block's scaled pivot rows
  __shared__ __align__(16) float s_row[2][R][32 * C];
  const int w = threadIdx.x / 32, t = threadIdx.x % 32, c0 = t * C;
  const size_t offset = static_cast<size_t>(blockIdx.x) * PB * PB;

  float v[R][C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int c = c0 + q;
#pragma unroll
    for (int h = 0; h < R; h += 4) {
      float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < PB)
        m = *reinterpret_cast<const float4*>(panels + offset + c * PB +
                                             w * R + h);
      v[h][q] = m.x, v[h + 1][q] = m.y, v[h + 2][q] = m.z, v[h + 3][q] = m.w;
    }
  }

  // block k: the steps i = k R + j of warp k's pivots (see block_steps)
  if constexpr (PB <= kUnrolledPanel) {
#pragma unroll
    for (int k = 0; k < W; ++k) block_steps<PB>(k, w, c0, v, s_row);
  } else {
#pragma unroll 1
    for (int k = 0; k < W; ++k) block_steps<PB>(k, w, c0, v, s_row);
  }

  // row r holds column r of L from its diagonal down: L[c, r] for c >= r,
  // the strict upper triangle zero
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int c = c0 + q;
    if (c >= PB) continue;
#pragma unroll
    for (int h = 0; h < R; h += 4) {
      const int r = w * R + h;
      *reinterpret_cast<float4*>(out + offset + c * PB + r) = make_float4(
          c >= r ? v[h][q] : 0.0f, c >= r + 1 ? v[h + 1][q] : 0.0f,
          c >= r + 2 ? v[h + 2][q] : 0.0f, c >= r + 3 ? v[h + 3][q] : 0.0f);
    }
  }
}

// The largest panel the kernel takes.
constexpr int kMaxPanel = 128;

template <int PB>
void launch(const float* panels, float* out, int count,
            cudaStream_t stream) {
  panel_cholesky_kernel<PB>
      <<<count, CholeskyLayout<PB>::kThreads, 0, stream>>>(panels, out);
}

// The instance of pb, for every multiple of 8 up to kMaxPanel.
template <int PB = 8>
void launch_of(int pb, const float* panels, float* out, int count,
               cudaStream_t stream) {
  if constexpr (PB <= kMaxPanel) {
    if (pb == PB)
      launch<PB>(panels, out, count, stream);
    else
      launch_of<PB + 8>(pb, panels, out, count, stream);
  }
}

}  // namespace

extern "C" int sc_panel_cholesky(const float* panels, float* out, int count,
                                 int pb, void* stream) {
  if (pb % 8 != 0 || pb <= 0 || pb > kMaxPanel) return cudaErrorInvalidValue;
  if (count > 0)
    launch_of(pb, panels, out, count, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
