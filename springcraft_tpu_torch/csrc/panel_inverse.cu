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
// What bounds it on the H100: latency.  A panel is pb = 64 dependent steps
// of ~4k multiply-subtracts each; the main path runs 128 panels per launch
// and 16 dependent launches per chunk.
//
// Design: one thread block per panel with the whole augmented state in
// shared memory (64 x 128 floats = 32 KB), so the 64 steps touch no device
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
// The full-window entry applies every step's rank-1 update to all pb rows
// and all 2 pb columns, as the TPU kernel it replaces does: rows above the
// pivot take the coefficient 0 and the columns outside the window change
// nothing the output reads, so for an SPD panel the two entries agree bit
// for bit and the full one does about four times the work.  Its thread for
// column i overwrites the coefficients M[r, i] that the other columns read,
// so each step first copies them to a vector of their own in shared memory.

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

__global__ void panel_inverse_full_kernel(const float* __restrict__ panels,
                                          float* __restrict__ out, int pb) {
  extern __shared__ float s[];  // pb rows x 2 pb columns, then pb coefficients
  const int w = 2 * pb;
  float* coef = s + pb * w;
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
    const int c = threadIdx.x;  // columns c and pb + c
    const float row_lo = s[i * w + c], row_hi = s[i * w + pb + c];
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(s[i * w + i]));
    const float rs2 = __fmul_rn(rs, rs);
    for (int r = tid; r < pb; r += nthreads)
      coef[r] = r < i    ? 0.0f
                : r == i ? __fsub_rn(1.0f, rs)
                         : __fmul_rn(s[r * w + i], rs2);
    __syncthreads();
    for (int r = threadIdx.y; r < pb; r += blockDim.y) {
      const float cr = coef[r];
      s[r * w + c] = __fsub_rn(s[r * w + c], __fmul_rn(cr, row_lo));
      s[r * w + pb + c] = __fsub_rn(s[r * w + pb + c], __fmul_rn(cr, row_hi));
    }
    __syncthreads();
  }

  for (int e = tid; e < pb * pb; e += nthreads) {
    const int r = e / pb, c = e - r * pb;
    o[e] = c <= r ? s[r * w + pb + c] : 0.0f;
  }
}

}  // namespace

extern "C" int sc_panel_inverse_full(const float* panels, float* out,
                                     int count, int pb, void* stream) {
  if (count > 0) {
    const dim3 block(pb, kThreads / pb > 0 ? kThreads / pb : 1);
    const size_t smem =
        (2 * static_cast<size_t>(pb) * pb + pb) * sizeof(float);
    panel_inverse_full_kernel<<<count, block, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        panels, out, pb);
  }
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
