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
// pb = 64 dependent steps of ~4k multiply-subtracts each; the main path
// runs 128 panels per launch and 16 dependent launches per chunk.
//
// Its design: one thread block per panel with the whole augmented state
// in shared memory (64 x 128 floats = 32 KB), so the 64 steps touch no device
// memory.  Rows above the pivot are final (the shrink form of the TPU
// kernel), and only columns i+1 .. i+pb change anything the output depends
// on: left-half columns <= i are never read again, and right-half columns
// past pb + i are exact zeros in row i.  So each step updates the rows
// r >= i over a window of exactly pb columns — one thread per column
// (blockDim.x = pb) times blockDim.y row lanes.  Two barriers per step: all
// threads read the pivot row into registers before any thread overwrites
// it.  The _rn intrinsics keep the multiply and subtract separate, as in
// the plain PyTorch version (ops/spd_linalg.py).
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
// round-trips it through shared memory: a thread owns a fixed patch of 4
// rows x 4 columns of [M | I] (at pb = 64: 512 threads, 16 elements
// each).  At step i the owners of row i and of column i publish the pivot
// row, the column M[:, i] and the pivot's two coefficients (1 - rs, rs^2)
// into a double-buffered slot in shared memory; one barrier; then every
// thread applies its 16 independent updates from three vector loads.  The
// step loop is unrolled by 4, so which register holds row i and column i
// is known at compile time.  The updates keep the plain version's
// __fmul_rn / __fsub_rn order, so the output equals it and the shrink
// kernel bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void panel_inverse_kernel(const float* __restrict__ panels,
                                     float* __restrict__ out, int pb) {
  extern __shared__ float s[];  // pb rows x 2 pb columns
  const int w = 2 * pb;
  const float* a = panels + static_cast<size_t>(blockIdx.x) * pb * pb;
  float* o = out + static_cast<size_t>(blockIdx.x) * pb * pb;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < pb * w; e += nthreads) {
    const int r = e / w, c = e - r * w;
    s[e] = c < pb ? a[r * pb + c] : (c - pb == r ? 1.0f : 0.0f);
  }
  __syncthreads();

  for (int i = 0; i < pb; ++i) {
    const int c = i + 1 + threadIdx.x;  // window [i + 1, i + pb]
    const float row_i = s[i * w + c];
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(s[i * w + i]));
    const float rs2 = __fmul_rn(rs, rs);
    __syncthreads();
    for (int r = i + threadIdx.y; r < pb; r += blockDim.y) {
      const float coef =
          r == i ? __fsub_rn(1.0f, rs) : __fmul_rn(s[r * w + i], rs2);
      s[r * w + c] = __fsub_rn(s[r * w + c], __fmul_rn(coef, row_i));
    }
    __syncthreads();
  }

  for (int e = tid; e < pb * pb; e += nthreads) {
    const int r = e / pb, c = e - r * pb;
    o[e] = c <= r ? s[r * w + pb + c] : 0.0f;
  }
}

// Rows and columns of [M | I] per thread of the full-window kernel, and
// the largest panel it takes.
constexpr int kFullRows = 4;
constexpr int kFullCols = 4;
constexpr int kMaxPanel = 64;

// One block per panel, pb^2 / (2 R) threads (R = kFullRows): thread (ty,
// tx) holds rows ty R .. ty R + R - 1 and columns 4 tx .. 4 tx + 3 of
// [M | I].
__global__ void __launch_bounds__(2 * kMaxPanel * kMaxPanel /
                                  (kFullRows * kFullCols))
    panel_inverse_full_kernel(const float* __restrict__ panels,
                              float* __restrict__ out, int pb) {
  constexpr int R = kFullRows;
  // step i's row and column are register s % 4 of their owners
  constexpr int kUnroll = kFullCols;
  static_assert(R == kFullCols, "one unroll serves rows and columns");
  // double-buffered step slots: the pivot row, the pivot column, and
  // (1 - rs, rs^2) of the pivot
  __shared__ float4 s_row[2][2 * kMaxPanel / kFullCols];
  __shared__ __align__(16) float s_col[2][kMaxPanel];
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
      const float4 t = *reinterpret_cast<const float4*>(&s_col[b][r0]);
      const float col[R] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int p = 0; p < R; ++p) {
        const int r = r0 + p;
        // rows above the pivot take 0 (a non-finite pivot row still reaches
        // them, as in the TPU kernel)
        const float coef = r < i    ? 0.0f
                           : r == i ? piv.x
                                    : __fmul_rn(col[p], piv.y);
        v[p][0] = __fsub_rn(v[p][0], __fmul_rn(coef, row.x));
        v[p][1] = __fsub_rn(v[p][1], __fmul_rn(coef, row.y));
        v[p][2] = __fsub_rn(v[p][2], __fmul_rn(coef, row.z));
        v[p][3] = __fsub_rn(v[p][3], __fmul_rn(coef, row.w));
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
  if (pb % 8 != 0 || pb > kMaxPanel) return cudaErrorInvalidValue;
  if (count > 0)
    panel_inverse_full_kernel<<<count, pb * pb / (2 * kFullRows), 0,
                                static_cast<cudaStream_t>(stream)>>>(
        panels, out, pb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sc_panel_inverse(const float* panels, float* out, int count,
                                int pb, void* stream) {
  if (count > 0) {
    const dim3 block(pb, kThreads / pb > 0 ? kThreads / pb : 1);
    const size_t smem = 2 * static_cast<size_t>(pb) * pb * sizeof(float);
    panel_inverse_kernel<<<count, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(panels, out,
                                                                pb);
  }
  return static_cast<int>(cudaGetLastError());
}
