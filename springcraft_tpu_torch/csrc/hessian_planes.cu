// Ensemble ANM Hessian assembly: nine xyz component planes per conformer.
//
// Replaces the TPU kernel springcraft_tpu/ops/pallas_kernels.py:688
// `_hessian_ensemble_kernel` (reached through `hessian_pallas_ensemble(...,
// raw_planes=True)`), analytic force-field families only.
//
// What bounds it on the H100: memory writes.  Each conformer writes
// 9 * n^2 floats (415 MB for a 128-conformer chunk at n = 300) and reads
// only 12 n bytes of coordinates; the arithmetic per pair is ~30 flops.
//
// Design: the TPU kernel carries the row sums for the diagonal across its
// sequential column-tile grid in scratch and visits the diagonal tile last.
// GPU blocks run in no order, so here one WARP owns one whole row p of one
// conformer: it sweeps every column q with its lanes along q (so each of
// the nine plane stores is one coalesced 128-byte line per step), keeps the
// nine row sums in registers, reduces them with warp shuffles and writes the
// diagonal entries itself — no cross-block reduction and no second pass.
// A block of 8 warps stages its conformer's coordinates in shared memory
// (structure of arrays, 12 n bytes).
//
// Arithmetic follows the JAX kernel operation by operation, with the _rn
// intrinsics keeping nvcc from contracting multiply-adds into FMAs, so the
// cutoff decision and the off-diagonal entries follow the same roundings
// as the plain PyTorch version (ops/assembly.py); the diagonal's summation
// order differs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kInvariant = 0;
constexpr int kHinsen = 1;

__device__ __forceinline__ float spring_constant(int kind, float sq) {
  if (kind == kInvariant) return 1.0f;
  if (kind == kHinsen) {
    const float dist = fmaxf(__fsqrt_rn(sq), 2.9f);
    return dist < 4.0f
               ? __fsub_rn(__fmul_rn(dist, 860.0f), 2390.0f)
               : __fdiv_rn(1.28e6f, __fmul_rn(__fmul_rn(sq, sq), sq));
  }
  // pfenm
  return __fdiv_rn(1.0f, sq == 0.0f ? 1.0f : sq);
}

__global__ void hessian_planes_kernel(const float* __restrict__ coords,
                                      float* __restrict__ out, int batch,
                                      int n, int kind, float cutoff_sq,
                                      int has_cutoff) {
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

  const float px = xyz[p], py = xyz[n + p], pz = xyz[2 * n + p];
  const size_t plane_stride = static_cast<size_t>(batch) * n * n;
  float* row = out + (static_cast<size_t>(b) * n + p) * n;

  float acc[9];
#pragma unroll
  for (int ab = 0; ab < 9; ++ab) acc[ab] = 0.0f;

  for (int q = lane; q < n; q += 32) {
    float d[3];
    d[0] = __fsub_rn(px, xyz[q]);
    d[1] = __fsub_rn(py, xyz[n + q]);
    d[2] = __fsub_rn(pz, xyz[2 * n + q]);
    const float sq = __fadd_rn(
        __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
        __fmul_rn(d[2], d[2]));
    const bool valid = (q != p) && (!has_cutoff || sq <= cutoff_sq);
    const float k = valid ? spring_constant(kind, sq) : 0.0f;
    const float g = __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ga = __fmul_rn(g, d[a]);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float v = __fmul_rn(ga, d[e]);
        acc[3 * a + e] += v;
        if (q != p) row[(3 * a + e) * plane_stride + q] = v;
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
    for (int ab = 0; ab < 9; ++ab) row[ab * plane_stride + p] = -acc[ab];
  }
}

}  // namespace

extern "C" int sc_hessian_planes(const float* coords, float* out, int batch,
                                 int n, int kind, float cutoff_sq,
                                 int has_cutoff, void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, batch);
    const size_t smem = 3 * static_cast<size_t>(n) * sizeof(float);
    hessian_planes_kernel<<<grid, 32 * kWarpsPerBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        coords, out, batch, n, kind, cutoff_sq, has_cutoff);
  }
  return static_cast<int>(cudaGetLastError());
}
