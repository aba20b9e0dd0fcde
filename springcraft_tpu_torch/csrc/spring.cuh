// Pair arithmetic shared by the assembly kernels (hessian_planes.cu,
// kirchhoff.cu): the squared distance and the analytic spring-constant
// rules of springcraft_tpu/ops/pallas_kernels.py:95-108
// (`_analytic_constants`), operation by operation.
//
// The _rn intrinsics keep nvcc from contracting multiply-adds into FMAs, so
// the cutoff decision and every pair value follow the same roundings as the
// plain PyTorch versions (ops/assembly.py).

#pragma once

#include <cuda_runtime.h>

namespace springcraft {

// Integer tags of the analytic families, as ops/ffparams.py's
// FFParams.kind_code gives them.
constexpr int kInvariant = 0;
constexpr int kHinsen = 1;

// dx * dx + dy * dy + dz * dz, in that order.
__device__ __forceinline__ float squared_distance(float dx, float dy,
                                                  float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Unmasked spring constant of a pair at squared distance `sq`.
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

// Spring constant of the pair (p, q), zero unless p != q and, with a
// cutoff, sq <= cutoff_sq.
__device__ __forceinline__ float masked_spring_constant(int kind, float sq,
                                                        bool distinct,
                                                        float cutoff_sq,
                                                        int has_cutoff) {
  const bool valid = distinct && (!has_cutoff || sq <= cutoff_sq);
  return valid ? spring_constant(kind, sq) : 0.0f;
}

}  // namespace springcraft
