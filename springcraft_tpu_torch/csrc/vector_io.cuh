// n consecutive floats between registers and memory, as 16- or 8-byte
// accesses where n allows, for the panel kernels (panel_inverse.cu,
// panel_cholesky.cu); the caller keeps the alignment.

#pragma once

#include <cuda_runtime.h>

template <int N>
__device__ __forceinline__ void load_floats(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x, v[k + 1] = t.y, v[k + 2] = t.z, v[k + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + k);
      v[k] = t.x, v[k + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = v[k];
  }
}
