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
// detects a panel that is not SPD.  Only the lower triangle of the input is
// read.
//
// What bounds it on the H100: latency.  A panel is pb dependent steps of at
// most pb^2 / 2 multiply-subtracts with three barriers each; the panel's
// bytes (32 KB read and written at pb = 64) take microseconds.
//
// Design: one thread block per panel with the panel in shared memory, rows
// padded by one float so that the column reads L[c, i] of the update do not
// collide on one bank (pb + 1 floats a row: 16.6 KB at pb = 64, 66 KB at
// pb = 128, which passes the 48 KB default and opts in).  One thread per
// column (blockDim.x = pb) times blockDim.y row lanes, as panel_inverse.cu.
// The _rn intrinsics keep the multiply and subtract separate, as in the
// plain PyTorch version (ops/spd_linalg.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void panel_cholesky_kernel(const float* __restrict__ panels,
                                      float* __restrict__ out, int pb) {
  extern __shared__ float s[];  // pb rows x (pb + 1) columns
  const int ld = pb + 1;
  const float* a = panels + static_cast<size_t>(blockIdx.x) * pb * pb;
  float* o = out + static_cast<size_t>(blockIdx.x) * pb * pb;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < pb * pb; e += nthreads) {
    const int r = e / pb, c = e - r * pb;
    s[r * ld + c] = a[e];
  }
  __syncthreads();

  for (int i = 0; i < pb; ++i) {
    // every thread reads the pivot before column i is scaled
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(s[i * ld + i]));
    __syncthreads();
    for (int r = i + tid; r < pb; r += nthreads)
      s[r * ld + i] = __fmul_rn(s[r * ld + i], rs);
    __syncthreads();
    const int c = threadIdx.x;
    if (c > i) {
      const float lc = s[c * ld + i];
      for (int r = c + threadIdx.y; r < pb; r += blockDim.y)
        s[r * ld + c] =
            __fsub_rn(s[r * ld + c], __fmul_rn(s[r * ld + i], lc));
    }
    __syncthreads();
  }

  for (int e = tid; e < pb * pb; e += nthreads) {
    const int r = e / pb, c = e - r * pb;
    o[e] = c <= r ? s[r * ld + c] : 0.0f;
  }
}

}  // namespace

extern "C" int sc_panel_cholesky(const float* panels, float* out, int count,
                                 int pb, void* stream) {
  if (count > 0) {
    const dim3 block(pb, kThreads / pb > 0 ? kThreads / pb : 1);
    const size_t smem = static_cast<size_t>(pb) * (pb + 1) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t opt = cudaFuncSetAttribute(
          panel_cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (opt != cudaSuccess) return static_cast<int>(opt);
    }
    panel_cholesky_kernel<<<count, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(panels, out,
                                                                 pb);
  }
  return static_cast<int>(cudaGetLastError());
}
