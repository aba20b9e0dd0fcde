// Regularized, equilibrated, identity-padded factor input straight from the
// coordinates: the nine Hessian planes never reach device memory.
//
// Replaces the TPU kernel springcraft_tpu/ops/pallas_kernels.py:1192
// `_assembly_stitch_kernel` (reached through `assembly_stitch_pallas`, from
// springcraft_tpu/ops/rigid.py `_regularize_equilibrated_direct`).  Analytic
// force-field families, as there.
//
//   reg[b, a n + p, e n + q] = H_ae[p, q] s[a n + p] s[e n + q]
//                              + sum_k ts[b, a n + p, k] ts[b, e n + q, k]
//   reg[b, r, r] = 1   (r >= 3 n),     reg[b, r, c] = 0   otherwise
//
// with H_ae[p, q] = (g d_a) d_e, g = -k / sq, for p != q and the negated
// row sum on the diagonal (hessian_planes.cu), s = scale_h[b] (the Jacobi
// scale with the mass weights folded in) and ts[b] = S T sqrt(sigma).  The
// scale is a global function of the Hessian's diagonal, so the caller
// computes it first (ops/rigid.py, plain PyTorch, as it is plain XLA in the
// JAX package).
//
// What bounds it on the H100: the one write of reg, B mp^2 floats (537 MB
// for a 128-conformer chunk at mp = 1024); it reads 12 n bytes of
// coordinates and 84 n bytes of scale and basis per conformer.  About 45
// flops per element with the rank-6 term.
//
// Design: hessian_planes.cu's.  One warp owns atom p of one conformer, that
// is the three output rows a n + p: its lanes sweep the column atoms q, so
// each of the nine stores per step is one coalesced 128-byte line; the nine
// row sums stay in registers, are reduced by warp shuffles, and the warp
// writes its nine diagonal entries and the zero pad of its rows itself.
// Blocks past the last atom write the identity rows of the pad.  The block
// stages its conformer's coordinates and scale in shared memory (24 n
// bytes; the wrapper refuses n > 2048); the basis rows of the column atoms
// come from device memory through L1 (72 n bytes per conformer, re-read by
// every warp).  The TPU kernel's row segments, its packed 16-lane rows_aux
// and 8-row cols_aux layouts and the matrix-unit product for the rank-6
// term are artefacts of VMEM and the (8, 128) tiling and are not carried
// over: the rank-6 sum runs in k order 0..5 with separate multiplies and
// adds, as regularize_stitch.cu's does.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// sum_k tr[k] * tc[k], k = 0..5 in order, multiplies and adds separate.
__device__ __forceinline__ float rank6(const float* tr,
                                       const float* __restrict__ tc) {
  float rank = __fmul_rn(tr[0], __ldg(tc));
#pragma unroll
  for (int k = 1; k < 6; ++k)
    rank = __fadd_rn(rank, __fmul_rn(tr[k], __ldg(tc + k)));
  return rank;
}

__global__ void assembly_stitch_kernel(const float* __restrict__ coords,
                                       const float* __restrict__ scale_h,
                                       const float* __restrict__ ts,
                                       float* __restrict__ out, int n, int mp,
                                       int kind, float cutoff_sq,
                                       int has_cutoff, int atom_blocks) {
  extern __shared__ float smem[];  // x, y, z (n each), then scale (3 n)
  const int b = blockIdx.y;
  const int m = 3 * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ob = out + static_cast<size_t>(b) * mp * mp;

  if (static_cast<int>(blockIdx.x) >= atom_blocks) {
    // identity rows of the pad: one warp per row r in [3 n, mp)
    const int r = m + (blockIdx.x - atom_blocks) * kWarpsPerBlock + warp;
    if (r >= mp) return;
    float* row = ob + static_cast<size_t>(r) * mp;
    for (int c = lane; c < mp; c += 32) row[c] = c == r ? 1.0f : 0.0f;
    return;
  }

  springcraft::stage_coordinates(
      smem, coords + static_cast<size_t>(b) * n * 3, 0, n, n);
  float* scale = smem + 3 * n;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    scale[i] = scale_h[static_cast<size_t>(b) * m + i];
  __syncthreads();

  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n) return;  // whole warp leaves together

  const float* tsb = ts + static_cast<size_t>(b) * m * 6;
  float trow[3][6], srow[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    srow[a] = scale[a * n + p];
#pragma unroll
    for (int k = 0; k < 6; ++k) trow[a][k] = __ldg(tsb + (a * n + p) * 6 + k);
  }

  const float px = smem[p], py = smem[n + p], pz = smem[2 * n + p];
  float acc[9];
#pragma unroll
  for (int ae = 0; ae < 9; ++ae) acc[ae] = 0.0f;

  for (int q = lane; q < n; q += 32) {
    float d[3];
    d[0] = __fsub_rn(px, smem[q]);
    d[1] = __fsub_rn(py, smem[n + q]);
    d[2] = __fsub_rn(pz, smem[2 * n + q]);
    const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
    const float k = springcraft::masked_spring_constant(kind, sq, q != p,
                                                        cutoff_sq, has_cutoff);
    const float g = __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int c = e * n + q;
      const float sc = scale[c];
      const float* tc = tsb + static_cast<size_t>(c) * 6;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = __fmul_rn(__fmul_rn(g, d[a]), d[e]);
        acc[3 * a + e] += v;
        if (q != p)
          ob[static_cast<size_t>(a * n + p) * mp + c] = __fadd_rn(
              __fmul_rn(__fmul_rn(v, srow[a]), sc), rank6(trow[a], tc));
      }
    }
  }

#pragma unroll
  for (int ae = 0; ae < 9; ++ae) {
    float s = acc[ae];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[ae] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int c = e * n + p;
        ob[static_cast<size_t>(a * n + p) * mp + c] = __fadd_rn(
            __fmul_rn(__fmul_rn(-acc[3 * a + e], srow[a]), scale[c]),
            rank6(trow[a], tsb + static_cast<size_t>(c) * 6));
      }
  }
  // zero pad of the warp's three rows, columns [3 n, mp)
  for (int a = 0; a < 3; ++a)
    for (int c = m + lane; c < mp; c += 32)
      ob[static_cast<size_t>(a * n + p) * mp + c] = 0.0f;
}

}  // namespace

extern "C" int sc_assembly_stitch(const float* coords, const float* scale_h,
                                  const float* ts, float* out, int batch,
                                  int n, int mp, int kind, float cutoff_sq,
                                  int has_cutoff, void* stream) {
  if (batch > 0 && mp > 0) {
    const int atom_blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int pad_blocks =
        (mp - 3 * n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const dim3 grid(atom_blocks + pad_blocks, batch);
    const size_t smem = 6 * static_cast<size_t>(n) * sizeof(float);
    assembly_stitch_kernel<<<grid, 32 * kWarpsPerBlock, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        coords, scale_h, ts, out, n, mp, kind, cutoff_sq, has_cutoff,
        atom_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
