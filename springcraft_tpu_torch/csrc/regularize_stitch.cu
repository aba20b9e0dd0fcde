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
// floats and writes mp^2 output floats (415 MB in and 537 MB out for a
// 128-conformer chunk at n = 300, mp = 1024); the rank-6 term is 11 flops
// per element.
//
// Design: a block writes a band of kBandRows rows of one conformer over a
// tile of kTileCols columns; each thread owns kGroup consecutive columns
// and writes them with one 16-byte streaming store a row (mp is a
// multiple of 4, so rows stay 16-byte aligned).  A thread keeps its
// columns' ts, scale and plane offsets in registers for the whole band;
// the band's row-side ts and scale are staged once in shared memory and
// read as broadcasts.  When n is a multiple of 4 (and the planes 16-byte
// aligned) a group never straddles a plane or the 3n edge, and its plane
// values are one 16-byte streaming load; otherwise each column is loaded
// on its own.  A thread issues the plane loads of kRowStep rows before it
// computes and stores them.  Pad rows and pad columns are written without
// reading anything.  The arithmetic order is fixed: the rank-6 sum in k
// order with separate multiplies and adds (as the TPU kernel's VPU
// multiply-adds), then (h sr) sc + rank (the card tests hold it bit for bit
// against that order written out over tensors).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 4;
constexpr int kThreads = 256;
constexpr int kTileCols = kGroup * kThreads;
constexpr int kBandRows = 16;
// row-side values per row in shared memory: ts[r, 0..5], scale_h[r]
constexpr int kSide = 7;
// rows whose plane loads a thread issues before it computes and stores
constexpr int kRowStep = 4;

__device__ __forceinline__ float stitch(float h, float sr, float sc,
                                        const float* tr, const float* tc) {
  float rank = __fmul_rn(tr[0], tc[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) rank = __fadd_rn(rank, __fmul_rn(tr[k], tc[k]));
  return __fadd_rn(__fmul_rn(__fmul_rn(h, sr), sc), rank);
}

// One band of rows of one conformer over one column tile.  kVector: n is a
// multiple of 4 and the planes 16-byte aligned, so a group lies inside one
// plane (and inside 3n) and its plane values are one 16-byte load.
template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    regularize_stitch_kernel(const float* __restrict__ planes,
                             const float* __restrict__ scale_h,
                             const float* __restrict__ ts,
                             float* __restrict__ out, int batch, int n,
                             int mp) {
  __shared__ float s_side[kBandRows][kSide];
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kBandRows;
  const int rows = min(kBandRows, mp - r0);
  const int m = 3 * n;
  const int data_rows = max(0, min(rows, m - r0));
  const float* ts_b = ts + static_cast<size_t>(b) * m * 6;
  const float* scale_b = scale_h + static_cast<size_t>(b) * m;
  for (int e = threadIdx.x; e < data_rows * kSide; e += kThreads) {
    const int rr = e / kSide, k = e - rr * kSide, r = r0 + rr;
    s_side[rr][k] = k < 6 ? ts_b[r * 6 + k] : scale_b[r];
  }
  __syncthreads();

  const int c0 = blockIdx.x * kTileCols + threadIdx.x * kGroup;
  if (c0 >= mp) return;
  float* o = out + (static_cast<size_t>(b) * mp + r0) * mp + c0;
  int rr = 0;
  if (c0 < m) {
    // the column side, for the whole band: ts, scale, and where each
    // column lies in the planes of a plane row (plane c / n, column c % n)
    const size_t plane_stride = static_cast<size_t>(batch) * n * n;
    float tc[kGroup][6], sc[kGroup];
    size_t col_off[kVector ? 1 : kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int c = min(c0 + k, m - 1);
#pragma unroll
      for (int j = 0; j < 6; ++j) tc[k][j] = ts_b[c * 6 + j];
      sc[k] = scale_b[c];
      if (!kVector || k == 0) {
        const int ca = c / n;
        col_off[k] = ca * plane_stride + (c - ca * n);
      }
    }
    // kRowStep rows at a time: their plane loads in flight together
    int ra = r0 / n, p = r0 - ra * n;
    for (; rr < data_rows; rr += kRowStep) {
      float h[kRowStep][kGroup];
#pragma unroll
      for (int j = 0; j < kRowStep; ++j) {
        if (rr + j < data_rows) {
          const float* h_row =
              planes + (3 * ra * static_cast<size_t>(batch) + b) * n * n +
              static_cast<size_t>(p) * n;
          if constexpr (kVector) {
            const float4 t =
                __ldcs(reinterpret_cast<const float4*>(h_row + col_off[0]));
            h[j][0] = t.x, h[j][1] = t.y, h[j][2] = t.z, h[j][3] = t.w;
          } else {
#pragma unroll
            for (int k = 0; k < kGroup; ++k)
              h[j][k] = c0 + k < m ? __ldcs(h_row + col_off[k]) : 0.0f;
          }
          if (++p == n) p = 0, ++ra;
        }
      }
#pragma unroll
      for (int j = 0; j < kRowStep; ++j) {
        if (rr + j < data_rows) {
          float tr[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) tr[k] = s_side[rr + j][k];
          const float sr = s_side[rr + j][6];
          float v[kGroup];
#pragma unroll
          for (int k = 0; k < kGroup; ++k)
            v[k] = kVector || c0 + k < m
                       ? stitch(h[j][k], sr, sc[k], tr, tc[k])
                       : 0.0f;
          __stcs(reinterpret_cast<float4*>(o + static_cast<size_t>(j) * mp),
                 make_float4(v[0], v[1], v[2], v[3]));
        }
      }
      o += static_cast<size_t>(kRowStep) * mp;
    }
    o -= static_cast<size_t>(rr - data_rows) * mp;
    rr = data_rows;
  }
  // the pad: identity rows below 3n, zero columns right of it
  for (; rr < rows; ++rr, o += mp) {
    const int r = r0 + rr;
    __stcs(reinterpret_cast<float4*>(o),
           make_float4(r == c0 ? 1.0f : 0.0f, r == c0 + 1 ? 1.0f : 0.0f,
                       r == c0 + 2 ? 1.0f : 0.0f, r == c0 + 3 ? 1.0f : 0.0f));
  }
}

}  // namespace

extern "C" int sc_regularize_stitch(const float* planes, const float* scale_h,
                                    const float* ts, float* out, int batch,
                                    int n, int mp, void* stream) {
  if (mp % kGroup != 0 || n <= 0 || mp < 3 * n) return cudaErrorInvalidValue;
  if (batch > 0) {
    const dim3 grid((mp + kTileCols - 1) / kTileCols,
                    (mp + kBandRows - 1) / kBandRows, batch);
    const auto s = static_cast<cudaStream_t>(stream);
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0)
      regularize_stitch_kernel<true>
          <<<grid, kThreads, 0, s>>>(planes, scale_h, ts, out, batch, n, mp);
    else
      regularize_stitch_kernel<false>
          <<<grid, kThreads, 0, s>>>(planes, scale_h, ts, out, batch, n, mp);
  }
  return static_cast<int>(cudaGetLastError());
}
