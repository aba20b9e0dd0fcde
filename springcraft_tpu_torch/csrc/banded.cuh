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
//
// The step is fused: each multiply-subtract is one fused multiply-add,
// about half the float64 instructions of the plain version's separately
// rounded products and differences (ops/spectrum.py `_Window`), and the
// reciprocal of the pivot is the hardware's approximation refined by two
// Newton steps (within an ulp or two of 1 / pivot, and a shorter dependent
// chain than the correctly rounded __drcp_rn, which bounds a step where few
// warps share a scheduler).  Either rounding change is a perturbation of
// the order of the elimination's own backward error: a Sturm count, which
// reads only the pivots' signs, can change only where the shift lies within
// that error of an eigenvalue, and both branches then end within that
// error, plus one final interval width, of it; an inverse-iteration vector
// moves by that error times its condition.
//
// The feed is read as T: double where the kernel stages it in shared
// memory as float64 (converted once per block instead of W conversions a
// step), float otherwise.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace banded {

__host__ __device__ constexpr int tri(int p, int q) {
  return q * (q + 1) / 2 + p;
}

template <int W>
constexpr int kSlots = W * (W + 1) / 2;

// The window before the first elimination: A[p, q] (= feed[p - q + b][q])
// with `shift` taken off the diagonal.
template <int W, typename T>
__device__ __forceinline__ void init_window(double (&u)[kSlots<W>],
                                            const T* f, int stride,
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

// 1 / x: the approximation rcp.approx.ftz.f64 gives, about 20 bits,
// refined by two Newton steps.
__device__ __forceinline__ double inv_pivot(double x) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  double e = fma(-x, y, 1.0);
  y = fma(y, e, y);
  e = fma(-x, y, 1.0);
  return fma(y, e, y);
}

// The window's last column: band column `col` as it stands in the band,
// with `shift` taken off its diagonal (no elimination has touched it yet).
template <int W, typename T>
__device__ __forceinline__ void load_last_column(double (&u)[kSlots<W>],
                                                 const T* f, int stride,
                                                 int col, double shift) {
#pragma unroll
  for (int p = 0; p < W; ++p) {
    const double a = f[p * stride + col];
    u[tri(p, W - 1)] = p == W - 1 ? __dsub_rn(a, shift) : a;
  }
}

// Eliminate the pivot with multipliers `l` and append band column `col`.
template <int W, typename T>
__device__ __forceinline__ void eliminate_append(double (&u)[kSlots<W>],
                                                 const double (&l)[W],
                                                 const T* f, int stride,
                                                 int col, double shift) {
  double r[W];
#pragma unroll
  for (int q = 0; q < W; ++q) r[q] = u[tri(0, q)];
#pragma unroll
  for (int q = 0; q < W - 1; ++q) {
#pragma unroll
    for (int p = 0; p <= q; ++p) {
      u[tri(p, q)] = fma(-l[p + 1], r[q + 1], u[tri(p + 1, q + 1)]);
    }
  }
  load_last_column<W>(u, f, stride, col, shift);
}

__device__ __forceinline__ double clamp_pivot(double pivot, double floor) {
  return fabs(pivot) < floor ? (pivot < 0.0 ? -floor : floor) : pivot;
}

// Stage one matrix's feed (`count` floats) in shared memory as T when
// `staged`, else (T = float only) read it from device memory through L1;
// returns where to read.  Every thread of the block must call it (it holds
// a barrier).
template <typename T>
__device__ __forceinline__ const T* stage_feed(const float* g, T* s,
                                               int count, bool staged) {
  if (staged) {
    for (int e = threadIdx.x; e < count; e += blockDim.x)
      s[e] = static_cast<T>(g[e]);
  }
  __syncthreads();
  if constexpr (std::is_same_v<T, float>) {
    return staged ? s : g;
  } else {
    return s;
  }
}

// Where a kernel keeps a feed of W (n + W) values beside `extra` bytes of
// other shared memory: float64 in shared memory where both fit under the
// device's per-block limit, else float32, else device memory (the kernel
// reads it through L1).  `smem` is the dynamic shared memory to launch
// with.
enum class Feed { kDouble, kFloat, kDevice };

inline cudaError_t feed_form(int w, int n, size_t extra, Feed* form,
                             size_t* smem) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(w) * (n + w);
  const auto limit = static_cast<size_t>(optin);
  if (extra > limit) return cudaErrorInvalidValue;
  if (extra + sizeof(double) * count <= limit) {
    *form = Feed::kDouble;
    *smem = extra + sizeof(double) * count;
  } else if (extra + sizeof(float) * count <= limit) {
    *form = Feed::kFloat;
    *smem = extra + sizeof(float) * count;
  } else {
    *form = Feed::kDevice;
    *smem = extra;
  }
  return cudaSuccess;
}

// Raise `kernel`'s dynamic shared-memory limit past the 48 KB default where
// `smem` needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace banded
