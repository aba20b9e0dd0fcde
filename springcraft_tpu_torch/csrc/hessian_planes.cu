// ANM Hessian assembly of a conformer batch, in two output layouts: the
// nine xyz component planes (9, B, n, n), or the dense xyz-layout Hessians
// (B, 3n, 3n).
//
// Replaces the TPU kernels
// * springcraft_tpu/ops/pallas_kernels.py:688 `_hessian_ensemble_kernel`
//   (reached through `hessian_pallas_ensemble(..., raw_planes=True)`), as
//   the planes layout (entry sc_hessian_planes);
// * springcraft_tpu/ops/pallas_kernels.py:191 `_hessian_kernel` (reached
//   through `hessian_pallas`, whose nine plane outputs are then
//   concatenated at :364-374), as the xyz layout (entry sc_hessian_xyz):
//   the concatenation is folded into the store address,
//   H[b, a n + p, e n + q].  The single structure runs at B = 1; the JAX
//   package's vmap of `hessian_pallas` over an ensemble runs at B = chunk.
// Analytic force-field families only.
//
// What bounds it on the H100: memory writes.  Each conformer writes
// 9 * n^2 floats (415 MB for a 128-conformer chunk at n = 300, 114 MB for
// one structure at n = 1776) and reads only 12 n bytes of coordinates; the
// arithmetic per pair is ~30 flops.
//
// Design: the TPU kernels carry the row sums for the diagonal across their
// sequential column-tile grid in scratch and visit the diagonal tile last.
// GPU blocks run in no order, so here one WARP owns one whole row p of one
// conformer: it sweeps every column q with its lanes along q (so each of
// the nine stores is one coalesced 128-byte line per step, in either
// layout), keeps the nine row sums in registers, reduces them with warp
// shuffles and writes the diagonal entries itself — no cross-block
// reduction and no second pass.  A block of 8 warps stages its conformer's
// coordinates in shared memory (structure of arrays, 12 n bytes: 21 KB at
// n = 1776; the wrapper refuses n > 4096, past the 48 KB default).
//
// Arithmetic follows the JAX kernels operation by operation (spring.cuh);
// the diagonal's summation order differs.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void hessian_kernel(const float* __restrict__ coords,
                               float* __restrict__ out, int batch, int n,
                               int kind, float cutoff_sq, int has_cutoff,
                               int xyz_layout) {
  extern __shared__ float xyz[];  // x[0:n], y[n:2n], z[2n:3n]
  const int b = blockIdx.y;
  const float* c = coords + static_cast<size_t>(b) * n * 3;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    const int atom = i / 3;
    xyz[(i - atom * 3) * n + atom] = c[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n) return;  // whole warp leaves together

  // Element (a, e, q) of row p lies at row[a * a_stride + e * e_stride + q].
  const size_t nn = static_cast<size_t>(n) * n;
  float* row;
  size_t a_stride, e_stride;
  if (xyz_layout) {
    row = out + (static_cast<size_t>(b) * 3 * n + p) * 3 * n;
    a_stride = 3 * nn;
    e_stride = n;
  } else {
    row = out + (static_cast<size_t>(b) * n + p) * n;
    e_stride = static_cast<size_t>(batch) * nn;
    a_stride = 3 * e_stride;
  }

  const float px = xyz[p], py = xyz[n + p], pz = xyz[2 * n + p];
  float acc[9];
#pragma unroll
  for (int ab = 0; ab < 9; ++ab) acc[ab] = 0.0f;

  for (int q = lane; q < n; q += 32) {
    float d[3];
    d[0] = __fsub_rn(px, xyz[q]);
    d[1] = __fsub_rn(py, xyz[n + q]);
    d[2] = __fsub_rn(pz, xyz[2 * n + q]);
    const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
    const float k = springcraft::masked_spring_constant(kind, sq, q != p,
                                                        cutoff_sq, has_cutoff);
    const float g = __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ga = __fmul_rn(g, d[a]);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float v = __fmul_rn(ga, d[e]);
        acc[3 * a + e] += v;
        if (q != p) row[a * a_stride + e * e_stride + q] = v;
      }
    }
  }

#pragma unroll
  for (int ab = 0; ab < 9; ++ab) {
    float s = acc[ab];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[ab] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int e = 0; e < 3; ++e)
        row[a * a_stride + e * e_stride + p] = -acc[3 * a + e];
  }
}

int launch(const float* coords, float* out, int batch, int n, int kind,
           float cutoff_sq, int has_cutoff, int xyz_layout, void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
    hessian_kernel<<<grid, 32 * kWarpsPerBlock, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        coords, out, batch, n, kind, cutoff_sq, has_cutoff, xyz_layout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sc_hessian_planes(const float* coords, float* out, int batch,
                                 int n, int kind, float cutoff_sq,
                                 int has_cutoff, void* stream) {
  return launch(coords, out, batch, n, kind, cutoff_sq, has_cutoff, 0,
                stream);
}

extern "C" int sc_hessian_xyz(const float* coords, float* out, int batch,
                              int n, int kind, float cutoff_sq,
                              int has_cutoff, void* stream) {
  return launch(coords, out, batch, n, kind, cutoff_sq, has_cutoff, 1,
                stream);
}
