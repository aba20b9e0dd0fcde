// Regularized, equilibrated, identity-padded factor input from the nine
// Hessian component planes.
//
// Replaces the TPU kernel springcraft_tpu/ops/pallas_kernels.py:1093
// `_regularize_stitch_kernel` (reached through `regularize_stitch_pallas`,
// from springcraft_tpu/ops/rigid.py `_regularize_equilibrated_planes`).
//
//   reg[b, r, c] = planes[3 (r / n) + c / n][b, r % n, c % n] * s[r] * s[c]
//                  + sum_k ts[b, r, k] ts[b, c, k]      (r, c < 3 n)
//   reg[b, r, r] = 1                                   (r >= 3 n)
//   reg[b, r, c] = 0                                   otherwise
//
// with s = scale_h[b] (the Jacobi scale, mass weights folded in) and
// ts[b] = S T sqrt(sigma), the scaled rigid-body basis.
//
// What bounds it on the H100: memory.  Per conformer it reads 9 n^2 plane
// floats and writes mp^2 output floats (537 MB out for a 128-conformer
// chunk at mp = 1024); the rank-6 term is 11 flops per element.
//
// Design: one thread per output element, threads along the column c so the
// output store and the plane read are coalesced (a column band of 3 planes
// is contiguous within each plane row).  The TPU kernel's packed rows_aux /
// cols_aux layouts, row-tile plans and two-pass misaligned-lane stores are
// artefacts of VMEM and (8, 128) tiling and are not carried over: the
// kernel reads scale_h (B, 3n) and ts (B, 3n, 6) as they are.  The rank-6
// sum runs in k order 0..5 with separate multiplies and adds, as the TPU
// kernel's VPU multiply-adds do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void regularize_stitch_kernel(const float* __restrict__ planes,
                                         const float* __restrict__ scale_h,
                                         const float* __restrict__ ts,
                                         float* __restrict__ out, int batch,
                                         int n, int mp) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= mp) return;
  const int m = 3 * n;
  float v;
  if (r < m && c < m) {
    const int ra = r / n, p = r - ra * n;
    const int ca = c / n, q = c - ca * n;
    const float h =
        planes[((static_cast<size_t>(3 * ra + ca) * batch + b) * n + p) * n +
               q];
    const float* tr = ts + (static_cast<size_t>(b) * m + r) * 6;
    const float* tc = ts + (static_cast<size_t>(b) * m + c) * 6;
    float rank = __fmul_rn(tr[0], tc[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) rank = __fadd_rn(rank, __fmul_rn(tr[k], tc[k]));
    const float sr = scale_h[static_cast<size_t>(b) * m + r];
    const float sc = scale_h[static_cast<size_t>(b) * m + c];
    v = __fadd_rn(__fmul_rn(__fmul_rn(h, sr), sc), rank);
  } else {
    v = (r == c) ? 1.0f : 0.0f;
  }
  out[(static_cast<size_t>(b) * mp + r) * mp + c] = v;
}

}  // namespace

extern "C" int sc_regularize_stitch(const float* planes, const float* scale_h,
                                    const float* ts, float* out, int batch,
                                    int n, int mp, void* stream) {
  if (batch > 0 && mp > 0) {
    const dim3 grid((mp + kThreads - 1) / kThreads, mp, batch);
    regularize_stitch_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        planes, scale_h, ts, out, batch, n, mp);
  }
  return static_cast<int>(cudaGetLastError());
}
