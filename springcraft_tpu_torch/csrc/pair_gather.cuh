// What the gather applies over the pair CSR (K13 in matfree_hessian.cu, K14
// in matfree_kirchhoff.cu) share: the warp's layout of (neighbour, column
// group) lanes, the column loads and stores, and the sums over lanes.
//
// A warp owns one row i and the columns [c0, c0 + kc) of one column chunk
// (kGatherCols = 64 columns; grid.y tiles wider X).  Its 32 lanes are
// `lpn` lanes per neighbour (a power of two) times 32 / lpn neighbours per
// step; lane (ns, gl) takes the column groups gl, gl + lpn, ..., GPL of
// them, each VEC floats wide (a float4 where k is a multiple of 4 and X is
// 16-byte aligned), so that the lanes of one neighbour read consecutive 16
// bytes, and `gather_shape` chooses (VEC, GPL, lpn) to leave no lane idle
// at the solvers' widths (48: 4 lanes x 3 float4; 24: 2 x 3; 4: 1 x 1).
//
// The slots and constants of 32 neighbours are read once, coalesced, one
// pair per lane, and what a pair needs is broadcast with __shfl_sync; the
// x_j rows of the next step are loaded before the current step's FMAs
// (register double buffering).  Every sum runs in a fixed order: pair by
// pair per lane, then a butterfly over the lanes, so two applies give the
// same bits.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace springcraft {

constexpr int kGatherWarps = 4;  // rows per block, one per warp
constexpr int kGatherThreads = 32 * kGatherWarps;
constexpr int kGatherCols = 64;  // columns per warp and pass
constexpr unsigned kFullMask = 0xffffffffu;

// The lane layout of one launch: VEC floats per column group, GPL groups
// per lane, lpn lanes per neighbour.
struct GatherShape {
  int vec, gpl, lpn;
};

// The layout that covers min(k, 64) columns with the fewest idle lane
// slots (at most 4 groups per lane; on a tie, more neighbours per step).
inline GatherShape gather_shape(int k, const void* x, const void* out) {
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int vec = (k % 4 == 0 && aligned) ? 4 : 1;
  const int kc = k < kGatherCols ? k : kGatherCols;
  const int groups = (kc + vec - 1) / vec;
  GatherShape best{vec, 0, 0};
  int best_waste = 1 << 30;
  for (int lpn = 1; lpn <= 32; lpn *= 2) {
    const int gpl = (groups + lpn - 1) / lpn;
    const int waste = lpn * gpl - groups;
    if (gpl <= 4 && waste < best_waste) {
      best = GatherShape{vec, gpl, lpn};
      best_waste = waste;
    }
  }
  return best;
}

// Which columns lane (ns, gl) of a warp covers.
template <int VEC, int GPL>
struct LaneColumns {
  int col[GPL];   // first column of each group, absolute
  bool has[GPL];  // inside this chunk
  int ns, npw;    // neighbour lane, neighbours per step

  __device__ __forceinline__ LaneColumns(int lane, int lpn, int k) {
    npw = 32 / lpn;
    ns = lane / lpn;
    const int gl = lane - ns * lpn;
    const int c0 = blockIdx.y * kGatherCols;
    const int kc = min(kGatherCols, k - c0);
#pragma unroll
    for (int q = 0; q < GPL; ++q) {
      const int c = (gl + q * lpn) * VEC;
      has[q] = c < kc;
      col[q] = c0 + c;
    }
  }

  // This lane's columns of one row `p` of X (zeros outside the chunk).
  __device__ __forceinline__ void load(const float* __restrict__ p,
                                       float (&v)[GPL][VEC]) const {
#pragma unroll
    for (int q = 0; q < GPL; ++q) {
      if (has[q]) {
        if constexpr (VEC == 4) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(p + col[q]));
          v[q][0] = t.x;
          v[q][1] = t.y;
          v[q][2] = t.z;
          v[q][3] = t.w;
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[q][c] = __ldg(p + col[q] + c);
        }
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[q][c] = 0.0f;
      }
    }
  }

  // Write this lane's columns of one row `p` of Y.
  __device__ __forceinline__ void store(float* __restrict__ p,
                                        const float (&v)[GPL][VEC]) const {
#pragma unroll
    for (int q = 0; q < GPL; ++q) {
      if (!has[q]) continue;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p + col[q]) =
            make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) p[col[q] + c] = v[q][c];
      }
    }
  }
};

// Sum `v` over the lanes whose index differs in the bits from `from` up:
// from = lpn sums over the neighbour lanes (each lane ends with the row's
// total of its columns), from = 1 over the whole warp.
__device__ __forceinline__ float lane_sum(float v, int from) {
  for (int offset = 16; offset >= from; offset >>= 1)
    v += __shfl_xor_sync(kFullMask, v, offset);
  return v;
}

}  // namespace springcraft
