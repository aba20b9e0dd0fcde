// The banded LDL^t window shared by the bisection (banded_bisect.cu) and
// inverse-iteration (banded_eigvec.cu) kernels.
//
// A band matrix of semi-bandwidth b = W - 1 arrives as its "feed", W rows of
// n + W floats: feed[p][i] = A[i - b + p, i], zero outside the band and on
// the W pad columns (ops/spectrum.py `band_feed`).  The LDL^t recurrence of
// A - s I keeps a sliding W x W Schur-complement window; it is symmetric, so
// only its upper triangle lives in registers, column by column:
// slot tri(p, q) = q (q + 1) / 2 + p for p <= q.  Step i takes pivot (0, 0),
// with l[p] = win[0][p] / pivot, and
//   new[p][q] = win[p + 1][q + 1] - l[p + 1] win[0][q + 1]   (q < W - 1),
//   new[p][W - 1] = feed[p][i + W] - s (p == W - 1).
// The window runs in double for both kernels: this elimination does not
// pivot, and in float32 its element growth flips the Sturm count's pivot
// signs and leaves about 0.5% of the inverse-iteration vectors unresolved.
// The _rn intrinsics keep each product and difference rounded on its own (no
// fused multiply-add), in the order of the plain PyTorch version
// (ops/spectrum.py `_Window`), so both compute the same pivots.
#pragma once

#include <cuda_runtime.h>

namespace banded {

__host__ __device__ constexpr int tri(int p, int q) {
  return q * (q + 1) / 2 + p;
}

template <int W>
constexpr int kSlots = W * (W + 1) / 2;

// The window before the first elimination: A[p, q] (= feed[p - q + b][q])
// with `shift` taken off the diagonal.
template <int W>
__device__ __forceinline__ void init_window(double (&u)[kSlots<W>],
                                            const float* f, int stride,
                                            double shift) {
#pragma unroll
  for (int q = 0; q < W; ++q) {
#pragma unroll
    for (int p = 0; p <= q; ++p) {
      const double a = f[(p - q + W - 1) * stride + q];
      u[tri(p, q)] = p == q ? __dsub_rn(a, shift) : a;
    }
  }
}

// l[p] = win[0][p] * inv_pivot for p >= 1 (l[0] is unused).
template <int W>
__device__ __forceinline__ void multipliers(const double (&u)[kSlots<W>],
                                            double inv_pivot, double (&l)[W]) {
#pragma unroll
  for (int p = 1; p < W; ++p) l[p] = __dmul_rn(u[tri(0, p)], inv_pivot);
}

// Eliminate the pivot with multipliers `l` and append band column `col`.
template <int W>
__device__ __forceinline__ void eliminate_append(double (&u)[kSlots<W>],
                                                 const double (&l)[W],
                                                 const float* f, int stride,
                                                 int col, double shift) {
  double r[W];
#pragma unroll
  for (int q = 0; q < W; ++q) r[q] = u[tri(0, q)];
#pragma unroll
  for (int q = 0; q < W - 1; ++q) {
#pragma unroll
    for (int p = 0; p <= q; ++p) {
      u[tri(p, q)] = __dsub_rn(u[tri(p + 1, q + 1)], __dmul_rn(l[p + 1], r[q + 1]));
    }
  }
#pragma unroll
  for (int p = 0; p < W; ++p) {
    const double a = f[p * stride + col];
    u[tri(p, W - 1)] = p == W - 1 ? __dsub_rn(a, shift) : a;
  }
}

__device__ __forceinline__ double clamp_pivot(double pivot, double floor) {
  return fabs(pivot) < floor ? (pivot < 0.0 ? -floor : floor) : pivot;
}

// Stage one matrix's feed (`count` floats) in shared memory when `staged`,
// else read it from device memory through L1; returns where to read.  Every
// thread of the block must call it (it holds a barrier).
__device__ __forceinline__ const float* stage_feed(const float* g, float* s,
                                                   int count, bool staged) {
  if (staged) {
    for (int e = threadIdx.x; e < count; e += blockDim.x) s[e] = g[e];
  }
  __syncthreads();
  return staged ? s : g;
}

// Dynamic shared memory for a feed of `bytes`: all of it when the device
// allows that much per block (raising the kernel's limit past the 48 KB
// default), else none (the kernel then reads device memory).
template <typename Kernel>
cudaError_t feed_smem(Kernel kernel, size_t bytes, size_t* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  *smem = bytes <= static_cast<size_t>(optin) ? bytes : 0;
  if (*smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
  return err;
}

}  // namespace banded
