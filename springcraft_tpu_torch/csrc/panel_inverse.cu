// Inverse Cholesky factor L^-1 of small SPD panels by augmented row
// elimination: the leaves of the divide-and-conquer inverse factor.
//
// Replaces the TPU kernels
// * springcraft_tpu/ops/pallas_linalg.py:142 `_panel_inverse_kernel_shrink`
//   (reached through `panel_inverse_batched(shrink_block=8)`, from
//   `_top_inverse_factor_parts`), entry sc_panel_inverse;
// * springcraft_tpu/ops/pallas_linalg.py:92 `_panel_inverse_kernel`
//   (reached through `panel_inverse_batched(shrink_block=None)`), the
//   full-window form of the same elimination, entry sc_panel_inverse_full.
//
// The state is the augmented [M | I] (pb x 2 pb).  Step i scales row i by
// rs = 1 / sqrt(M[i, i]) and eliminates column i below the pivot, both as
// one fused rank-1 update S[r, :] -= c[r] * S[i, :] with
//   c[i] = 1 - rs,   c[r] = rs^2 * M[r, i] (r > i),   c[r] = 0 (r < i);
// after pb steps the right half holds L^-1.  There is no pivot clamp: a
// non-positive pivot gives inf/NaN in the output, which is how the caller
// detects a matrix that is not SPD.
//
// What bounds the shrink kernel (K3) on the H100: latency.  A panel is
// pb dependent steps of at most pb x pb multiply-subtracts each; the main
// path runs 128 panels of pb = 64 per launch (one block an SM, nothing
// else to hide latency) and 16 dependent launches per chunk.  Both
// entries take every pb that is a multiple of 8 up to 128, the largest
// leaf of the JAX package's blocked inverse (its `block=` clamp).
//
// Its design.  In place: at step i only the columns i + 1 .. i + pb of
// [M | I] change anything the output reads (left-half columns <= i are
// never read again; right-half columns past pb + i are exact zeros in row
// i), and modulo pb they are one column each.  So the state is pb x pb:
// slot j holds left column j up to step j, whose coefficients it gives,
// and right column pb + j from then on (its value delta(r, j) before the
// step's update, the pivot row's 1 there).  The state lives in registers
// with fixed ownership: a row is 8 lanes of one warp holding pb / 8 slots
// each, a warp 4 rows (pb = 64: 16 warps; pb = 128: 32 warps, the most a
// block has, and 16 slots a lane).  Warp k runs the steps of its
// own 4 pivots alone, every value it needs passed by shuffles, and
// publishes each pivot row and its rs^2 to shared memory; the warps below
// apply each step as soon as it is published, meeting warp k on a named
// barrier per step (no block-wide barrier), so the next owner has the
// block's last step applied soon after it is published; a row's next
// coefficient input is shuffled before it waits.  Rows above the pivot
// are final and do no work (the shrink form).  Steps are unrolled, so a
// step's slot is a register known at compile time; each pb is its own
// instance.  Every element sees the same __fmul_rn / __fsub_rn sequence,
// and each pivot the same IEEE square root and reciprocal, as in the plain
// version, so the output equals it and K9 bit for bit.  A row's slots move
// as 16- or 8-byte accesses, so the panels must start on a 16-byte
// boundary (the wrapper checks).
//
// The full-window entry (K9) applies every step's rank-1 update to all pb
// rows and all 2 pb columns, as the TPU kernel it replaces does: rows above
// the pivot take the coefficient 0 and the columns outside the window
// change nothing the output reads, so for an SPD panel the two entries agree
// bit for bit and the full one does about four times the work.
//
// What bounds K9: the chain of 64 dependent steps, each a broadcast of the
// pivot row and column and 2 pb^2 multiply-subtracts, so each step's
// latency counts.  The design keeps the state in registers, so no step
// round-trips it through shared memory: a thread owns a fixed patch of R
// rows x 4 columns of [M | I]: R = 4 up to pb = 64 (512 threads, 16
// elements each), R = 8 above (pb = 128: 1,024 threads, the most a block
// has, 32 elements each; 64 registers a thread, so ptxas spills about 90
// bytes).  At step i the owners of row i and of column i publish the pivot
// row, the column M[:, i] and the pivot's two coefficients (1 - rs, rs^2)
// into a double-buffered slot in shared memory; one barrier; then every
// thread applies its 4 R independent updates from 1 + R / 4 vector loads.
// The step loop is unrolled by max(R, 4), so which register holds row i and
// column i is known at compile time.  The updates keep the plain version's
// __fmul_rn / __fsub_rn order, so the output equals it and the shrink
// kernel bit for bit.

#include <cuda_runtime.h>

#include "vector_io.cuh"

namespace {

// The shrink kernel's layout: a row is kLanes consecutive lanes of one warp,
// each holding kCols consecutive slots, so a warp holds kRows rows; warp w
// owns rows w kRows .. w kRows + kRows - 1 and the steps of those pivots.
template <int PB>
struct ShrinkLayout {
  static constexpr int kLanes = 8;
  static constexpr int kCols = PB / kLanes;
  static constexpr int kRows = 32 / kLanes;
  static constexpr int kWarps = PB / kRows;
  static constexpr int kThreads = 32 * kWarps;
};

// (1 - rs, rs^2) of the pivot x, rs = 1 / sqrt(x) by the IEEE square root
// and reciprocal, as in the plain version and K9; a pivot that is not
// positive gives a non-finite pair, so a panel that is not SPD gives a
// non-finite output.
__device__ __forceinline__ float2 pivot_coefficients(float x) {
  const float rs = __frcp_rn(__fsqrt_rn(x));
  return make_float2(__fsub_rn(1.0f, rs), __fmul_rn(rs, rs));
}

// One block per panel, ShrinkLayout<PB>::kThreads threads: lane g kLanes + l
// of warp w holds slots kCols l .. kCols l + kCols - 1 of row w kRows + g.
template <int PB>
__global__ void __launch_bounds__(ShrinkLayout<PB>::kThreads)
    panel_inverse_kernel(const float* __restrict__ panels,
                         float* __restrict__ out) {
  constexpr int L = ShrinkLayout<PB>::kLanes;
  constexpr int C = ShrinkLayout<PB>::kCols;
  constexpr int R = ShrinkLayout<PB>::kRows;
  constexpr int W = ShrinkLayout<PB>::kWarps;
  constexpr unsigned kAll = 0xffffffffu;
  // double-buffered by block of steps: the block's pivot rows as they
  // enter their steps (slot i set to the 1 of the identity), and each
  // pivot's rs^2
  __shared__ __align__(16) float s_row[2][R][PB];
  __shared__ __align__(16) float s_rs2[2][R];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / L, l = lane % L, c0 = l * C, r = w * R + g;
  const size_t offset = static_cast<size_t>(blockIdx.x) * PB * PB + r * PB;

  float v[C];
  load_floats(v, panels + offset + c0);

  // slot i of this row before step i: the row's coefficient is col rs^2
  float col = __shfl_sync(kAll, v[0], g * L);
  // block k: the steps i = k R + j of warp k's pivots.  Step j of every
  // block meets on named barrier 1 + j: warp k arrives when it has
  // published the step, the W - k - 1 warps below wait for it.  Two
  // buffers suffice: a warp writes block k + 2 only after it has waited
  // for every warp below at each step of block k + 1, so none of them
  // still reads block k.
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int buf = k & 1;
    const int waiting = 32 * (W - k);
    if (w == k) {
      // the block's steps inside the owning warp, pivots and rows by
      // shuffles; rows above the pivot are final
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = k * R + j, li = i / C, qi = i % C;
        float row[C];
#pragma unroll
        for (int q = 0; q < C; ++q)
          row[q] = __shfl_sync(kAll, v[q], j * L + l);
        if (l == li) row[qi] = 1.0f;
        col = __shfl_sync(kAll, v[qi], g * L + li);
        const float2 piv =
            pivot_coefficients(__shfl_sync(kAll, v[qi], j * L + li));
        // every row group holds the pivot row: all publish the same bits
        store_floats(&s_row[buf][j][c0], row);
        s_rs2[buf][j] = piv.y;
        if (k + 1 < W)
          asm volatile("bar.arrive %0, %1;" ::"r"(1 + j), "r"(waiting)
                       : "memory");
        if (g >= j) {
          const float coef = g == j ? piv.x : __fmul_rn(col, piv.y);
          // slot i turns into column pb + i: delta(r, i) before the update
          if (l == li) v[qi] = g == j ? 1.0f : 0.0f;
#pragma unroll
          for (int q = 0; q < C; ++q)
            v[q] = __fsub_rn(v[q], __fmul_rn(coef, row[q]));
        }
      }
    } else if (w > k) {
      // the rows below apply each step as soon as it is published
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int i = k * R + j, li = i / C, qi = i % C;
        asm volatile("bar.sync %0, %1;" ::"r"(1 + j), "r"(waiting)
                     : "memory");
        float row[C];
        load_floats(row, &s_row[buf][j][c0]);
        const float coef = __fmul_rn(col, s_rs2[buf][j]);
        if (l == li) v[qi] = 0.0f;
#pragma unroll
        for (int q = 0; q < C; ++q)
          v[q] = __fsub_rn(v[q], __fmul_rn(coef, row[q]));
        // the next step's slot, ahead of its barrier
        if (i + 1 < PB)
          col = __shfl_sync(kAll, v[(i + 1) % C], g * L + (i + 1) / C);
      }
    }
  }

  // slots c <= r hold L^-1; the rest of the row is zero
  float res[C];
#pragma unroll
  for (int q = 0; q < C; ++q) res[q] = c0 + q <= r ? v[q] : 0.0f;
  store_floats(out + offset + c0, res);
}

// The largest panel either kernel takes, and the largest the full-window
// kernel takes at 4 rows of [M | I] a thread (8 rows above it).
constexpr int kMaxPanel = 128;
constexpr int kFullNarrowPanel = 64;
// Columns of [M | I] per thread of the full-window kernel; its rows per
// thread R, the largest panel each R takes, so that 2 pb^2 / (4 R) threads
// stay within a block's 1,024, and the step unroll that keeps the owners'
// registers known at compile time.
constexpr int kFullCols = 4;
template <int R>
struct FullLayout {
  static constexpr int kMaxPanel = R == 4 ? kFullNarrowPanel : 128;
  static constexpr int kThreads = 2 * kMaxPanel * kMaxPanel / (R * kFullCols);
  static constexpr int kUnroll = R > kFullCols ? R : kFullCols;
};
static_assert(FullLayout<8>::kMaxPanel == kMaxPanel &&
                  FullLayout<8>::kThreads <= 1024,
              "the widest instance takes the largest panel in one block");

// One block per panel, pb^2 / (2 R) threads: thread (ty, tx) holds rows
// ty R .. ty R + R - 1 and columns 4 tx .. 4 tx + 3 of [M | I].
template <int R>
__global__ void __launch_bounds__(FullLayout<R>::kThreads)
    panel_inverse_full_kernel(const float* __restrict__ panels,
                              float* __restrict__ out, int pb) {
  constexpr int kMax = FullLayout<R>::kMaxPanel;
  // step i's row and column are register s % R and s % 4 of their owners
  constexpr int kUnroll = FullLayout<R>::kUnroll;
  static_assert(R % 4 == 0 && kUnroll % R == 0 && kUnroll % kFullCols == 0,
                "one unroll serves rows and columns");
  // double-buffered step slots: the pivot row, the pivot column, and
  // (1 - rs, rs^2) of the pivot
  __shared__ float4 s_row[2][2 * kMax / kFullCols];
  __shared__ __align__(16) float s_col[2][kMax];
  __shared__ float2 s_piv[2];
  const int tx_count = 2 * pb / kFullCols;
  const int tx = threadIdx.x % tx_count, ty = threadIdx.x / tx_count;
  const int r0 = ty * R, c0 = tx * kFullCols;
  const float* a = panels + static_cast<size_t>(blockIdx.x) * pb * pb;

  float v[R][kFullCols];
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < kFullCols; ++q) {
      const int r = r0 + p, c = c0 + q;
      v[p][q] = c < pb ? a[r * pb + c] : (c - pb == r ? 1.0f : 0.0f);
    }

  // pb is a multiple of 8, so of kUnroll
  for (int i0 = 0; i0 < pb; i0 += kUnroll) {
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      // step i = i0 + s: row i is row s % R of thread row i / R, column i
      // is column s % 4 of thread column i / 4
      const int i = i0 + s, b = s & 1;
      const int pr = s % R, pc = s % kFullCols;
      if (ty == i / R)
        s_row[b][tx] = make_float4(v[pr][0], v[pr][1], v[pr][2], v[pr][3]);
      if (tx == i / kFullCols) {
#pragma unroll
        for (int p = 0; p < R; ++p) s_col[b][r0 + p] = v[p][pc];
        if (ty == i / R) {
          const float rs = __fdiv_rn(1.0f, __fsqrt_rn(v[pr][pc]));
          s_piv[b] = make_float2(__fsub_rn(1.0f, rs), __fmul_rn(rs, rs));
        }
      }
      __syncthreads();
      const float4 row = s_row[b][tx];
      const float2 piv = s_piv[b];
      // the pivot column four rows at a time, so that at R = 8 no more
      // than four of its values are live beside the state
#pragma unroll
      for (int p4 = 0; p4 < R; p4 += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&s_col[b][r0 + p4]);
        const float col[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p4 + q, r = r0 + p;
          // rows above the pivot take 0 (a non-finite pivot row still
          // reaches them, as in the TPU kernel)
          const float coef = r < i    ? 0.0f
                             : r == i ? piv.x
                                      : __fmul_rn(col[q], piv.y);
          v[p][0] = __fsub_rn(v[p][0], __fmul_rn(coef, row.x));
          v[p][1] = __fsub_rn(v[p][1], __fmul_rn(coef, row.y));
          v[p][2] = __fsub_rn(v[p][2], __fmul_rn(coef, row.z));
          v[p][3] = __fsub_rn(v[p][3], __fmul_rn(coef, row.w));
        }
      }
    }
  }

  // the right half, lower triangle: L^-1
  if (c0 < pb) return;
  float* o = out + static_cast<size_t>(blockIdx.x) * pb * pb;
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < kFullCols; ++q) {
      const int r = r0 + p, c = c0 + q - pb;
      o[r * pb + c] = c <= r ? v[p][q] : 0.0f;
    }
}

}  // namespace

extern "C" int sc_panel_inverse_full(const float* panels, float* out,
                                     int count, int pb, void* stream) {
  if (pb % 8 != 0 || pb <= 0 || pb > kMaxPanel) return cudaErrorInvalidValue;
  if (count > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (pb <= kFullNarrowPanel)
      panel_inverse_full_kernel<4><<<count, pb * pb / (2 * 4), 0, s>>>(
          panels, out, pb);
    else
      panel_inverse_full_kernel<8><<<count, pb * pb / (2 * 8), 0, s>>>(
          panels, out, pb);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int PB>
void launch_shrink(const float* panels, float* out, int count,
                   cudaStream_t stream) {
  panel_inverse_kernel<PB>
      <<<count, ShrinkLayout<PB>::kThreads, 0, stream>>>(panels, out);
}

// The shrink kernel's instance of pb, for every multiple of 8 up to
// kMaxPanel.
template <int PB = 8>
void launch_shrink_of(int pb, const float* panels, float* out, int count,
                      cudaStream_t stream) {
  if constexpr (PB <= kMaxPanel) {
    if (pb == PB)
      launch_shrink<PB>(panels, out, count, stream);
    else
      launch_shrink_of<PB + 8>(pb, panels, out, count, stream);
  }
}

extern "C" int sc_panel_inverse(const float* panels, float* out, int count,
                                int pb, void* stream) {
  if (pb % 8 != 0 || pb <= 0 || pb > kMaxPanel) return cudaErrorInvalidValue;
  if (count > 0)
    launch_shrink_of(pb, panels, out, count,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
