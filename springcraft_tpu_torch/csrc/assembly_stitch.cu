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
// scale with the mass weights folded in) and ts[b] = S T sqrt(sigma).
//
// Two launches, one kernel in the sense of the TPU's:
// * `sc_assembly_row_sums` writes the (B, n, 9) diagonal superelements
//   rs[b, p, 3 a + e] = H_ae[p, p] = -sum_q (g d_a) d_e.  The scale is a
//   global function of the Hessian's diagonal (through sigma), so the
//   caller (ops/rigid.py) takes the three a == e sums as that diagonal,
//   computes the scale in plain PyTorch and hands all nine sums back to
// * `sc_assembly_stitch`, the store pass, a pure writer of reg.
//
// What bounds it on the H100: the one write of reg, B mp^2 floats (537 MB
// for a 128-conformer chunk at mp = 1024); it reads 12 n bytes of
// coordinates and 84 n bytes of scale and basis per conformer.  About 20
// instructions per element with the rank-6 term, so the store pass is as
// much a matter of instructions as of bytes; the row-sum pass is n^2 pair
// geometries per conformer.
//
// Row-sum pass: a conformer's coordinates staged in shared memory,
// kLanesPerAtom lanes per atom p; they sweep the column atoms q, computing
// each pair's geometry once and its nine products; each lane sums its
// columns in order, then the atom's lanes reduce by a fixed shuffle tree
// (no atomics).
//
// Store pass, K2's layout (regularize_stitch.cu): a block owns a band of
// kBandAtoms row atoms (3 kBandAtoms rows of reg) of one conformer over
// all mp columns.  The column side (coordinates, scale, the basis as it
// lies in device memory) is staged once per block in shared memory, 96 n
// bytes, and after it the band's row side (basis, scale, row sums); past
// 48 KB (n > 492) through the opt-in.  kVector (n % 4 == 0): a thread
// computes the geometry of 4 consecutive column atoms of one row atom once
// and emits nine 16-byte streaming stores, three rows a by three column
// groups e, 16-byte aligned because n and mp are multiples of 4; the pad
// columns of its rows are items of their own, written without reads.
// Otherwise a thread owns 4 consecutive (aligned) output columns of the
// three rows of one atom and computes each column's geometry.  Blocks past
// the last band write the identity rows of the pad.
//
// Arithmetic: the _rn intrinsics and the rank-6 sum in k order 0..5 (as
// regularize_stitch.cu's), so every off-diagonal element rounds as the
// plain version's (h s_r) s_c + rank.  The diagonal superelements differ
// from the plain version's by the summation order of the row sums only.
// The TPU kernel's row segments, its packed rows_aux / cols_aux layouts and
// the matrix-unit product for the rank-6 term are artefacts of VMEM and
// the (8, 128) tiling and are not carried over.

#include <cuda_runtime.h>

#include "spring.cuh"

namespace {

constexpr int kThreads = 256;
// the row-sum pass: warps of a block, lanes of an atom
constexpr int kRowSumWarps = 8;
constexpr int kLanesPerAtom = 16;
constexpr int kAtomsPerWarp = 32 / kLanesPerAtom;
// row atoms of a store block, and identity rows of a pad block
constexpr int kBandAtoms = 16;
constexpr int kPadRows = 16;
// row side per band atom: ts[a n + p, 0..5] for a = 0..2, scale_h[a n + p],
// then the nine row sums
constexpr int kSide = 30;

// sum_k tr[k] * tc[k], k = 0..5 in order, multiplies and adds separate.
__device__ __forceinline__ float rank6(const float* tr, const float* tc) {
  float rank = __fmul_rn(tr[0], tc[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) rank = __fadd_rn(rank, __fmul_rn(tr[k], tc[k]));
  return rank;
}

// (h s_r) s_c + rank, each operation rounded on its own.
__device__ __forceinline__ float stitch(float h, float sr, float sc,
                                        const float* tr, const float* tc) {
  return __fadd_rn(__fmul_rn(__fmul_rn(h, sr), sc), rank6(tr, tc));
}

__device__ __forceinline__ float pair_g(int kind, float sq, bool distinct,
                                        float cutoff_sq, int has_cutoff) {
  const float k = springcraft::masked_spring_constant(kind, sq, distinct,
                                                      cutoff_sq, has_cutoff);
  return __fdiv_rn(-k, sq == 0.0f ? 1.0f : sq);
}

__global__ void __launch_bounds__(32 * kRowSumWarps)
    row_sums_kernel(const float* __restrict__ coords,
                    float* __restrict__ row_sums, int n, int kind,
                    float cutoff_sq, int has_cutoff) {
  extern __shared__ float xyz[];
  const int b = blockIdx.y;
  springcraft::stage_coordinates(xyz, coords + static_cast<size_t>(b) * n * 3,
                                 0, n, n);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanesPerAtom;
  const int p = (blockIdx.x * kRowSumWarps + (threadIdx.x >> 5)) *
                    kAtomsPerWarp + lane / kLanesPerAtom;
  const bool active = p < n;
  float acc[9];
#pragma unroll
  for (int ae = 0; ae < 9; ++ae) acc[ae] = 0.0f;
  if (active) {
    const float px = xyz[p], py = xyz[n + p], pz = xyz[2 * n + p];
    for (int q = sub; q < n; q += kLanesPerAtom) {
      float d[3];
      d[0] = __fsub_rn(px, xyz[q]);
      d[1] = __fsub_rn(py, xyz[n + q]);
      d[2] = __fsub_rn(pz, xyz[2 * n + q]);
      const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
      const float g = pair_g(kind, sq, q != p, cutoff_sq, has_cutoff);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float gd = __fmul_rn(g, d[a]);
#pragma unroll
        for (int e = 0; e < 3; ++e) acc[3 * a + e] += __fmul_rn(gd, d[e]);
      }
    }
  }
#pragma unroll
  for (int ae = 0; ae < 9; ++ae) {
    float s = acc[ae];
#pragma unroll
    for (int off = kLanesPerAtom / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    acc[ae] = s;
  }
  if (active) {
    float* out = row_sums + (static_cast<size_t>(b) * n + p) * 9;
#pragma unroll
    for (int ae = 0; ae < 9; ++ae)
      if (ae % kLanesPerAtom == sub) out[ae] = -acc[ae];
  }
}

// The store pass's shared memory: the conformer's column side (x, y, z,
// scale, then ts as in device memory, ts[c][k] for c < 3 n); the band's
// row side follows it (stitch_smem_bytes).
struct ColumnSide {
  const float* x;
  const float* y;
  const float* z;
  const float* scale;
  const float* ts;  // ts[6 c + k]
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// At most 80 registers (three blocks an SM): measured ahead of the 128
// the compiler takes unbounded, which leave two.
template <bool kVector>
__global__ void __launch_bounds__(kThreads, 3)
    stitch_kernel(const float* __restrict__ coords,
                  const float* __restrict__ scale_h,
                  const float* __restrict__ ts,
                  const float* __restrict__ row_sums,
                  float* __restrict__ out, int n, int mp, int kind,
                  float cutoff_sq, int has_cutoff, int atom_bands) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float(*side)[kSide] = reinterpret_cast<float(*)[kSide]>(smem + 24 * n);
  const int b = blockIdx.y;
  const int m = 3 * n;
  float* ob = out + static_cast<size_t>(b) * mp * mp;

  if (static_cast<int>(blockIdx.x) >= atom_bands) {
    // identity rows of the pad, 16-byte groups
    const int r0 = m + (blockIdx.x - atom_bands) * kPadRows;
    const int rows = min(kPadRows, mp - r0);
    const int groups = mp / 4;
    for (int i = threadIdx.x; i < rows * groups; i += kThreads) {
      const int rr = i / groups, c0 = 4 * (i - rr * groups), r = r0 + rr;
      __stcs(reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * mp +
                                       c0),
             make_float4(r == c0 ? 1.0f : 0.0f, r == c0 + 1 ? 1.0f : 0.0f,
                         r == c0 + 2 ? 1.0f : 0.0f,
                         r == c0 + 3 ? 1.0f : 0.0f));
    }
    return;
  }

  // stage the column side and the band's row side
  const float* cb = coords + static_cast<size_t>(b) * n * 3;
  const float* sb = scale_h + static_cast<size_t>(b) * m;
  const float* tb = ts + static_cast<size_t>(b) * m * 6;
  const ColumnSide col{smem, smem + n, smem + 2 * n, smem + 3 * n,
                       smem + 6 * n};
  springcraft::stage_coordinates(smem, cb, 0, n, n);
  for (int i = threadIdx.x; i < m; i += kThreads)
    smem[3 * n + i] = sb[i];
  for (int i = threadIdx.x; i < 6 * m; i += kThreads) smem[6 * n + i] = tb[i];
  const int p0 = blockIdx.x * kBandAtoms;
  const int band = min(kBandAtoms, n - p0);
  for (int i = threadIdx.x; i < band * kSide; i += kThreads) {
    const int ra = i / kSide, k = i - ra * kSide, p = p0 + ra;
    float v;
    if (k < 18) {
      v = tb[((k / 6) * n + p) * 6 + k % 6];
    } else if (k < 21) {
      v = sb[(k - 18) * n + p];
    } else {
      v = row_sums[(static_cast<size_t>(b) * n + p) * 9 + (k - 21)];
    }
    side[ra][k] = v;
  }
  __syncthreads();

  if constexpr (kVector) {
    // per row atom: n / 4 column-atom groups (nine stores each), then the
    // pad groups of its three rows
    const int data = n / 4;
    const int per_atom = data + (mp - m) / 4;
    for (int i = threadIdx.x; i < band * per_atom; i += kThreads) {
      const int ra = i / per_atom, g = i - ra * per_atom, p = p0 + ra;
      const float* rside = side[ra];
      if (g >= data) {
        const int c0 = m + 4 * (g - data);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          __stcs(reinterpret_cast<float4*>(
                     ob + static_cast<size_t>(a * n + p) * mp + c0),
                 make_float4(0.0f, 0.0f, 0.0f, 0.0f));
        continue;
      }
      const int q0 = 4 * g;
      const float4 qx = ld4(col.x + q0), qy = ld4(col.y + q0),
                   qz = ld4(col.z + q0);
      const float px = col.x[p], py = col.y[p], pz = col.z[p];
      float d[3][4], gg[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[0][j] = __fsub_rn(px, at(qx, j));
        d[1][j] = __fsub_rn(py, at(qy, j));
        d[2][j] = __fsub_rn(pz, at(qz, j));
        const float sq = springcraft::squared_distance(d[0][j], d[1][j],
                                                       d[2][j]);
        gg[j] = pair_g(kind, sq, q0 + j != p, cutoff_sq, has_cutoff);
      }
      const int jd = p - q0;  // the diagonal's slot, if 0 <= jd < 4
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int c0 = e * n + q0;
        const float4 sc4 = ld4(col.scale + c0);
        float tc[24];  // ts of columns c0..c0 + 3, 96 contiguous bytes
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float4 t = ld4(col.ts + 6 * c0 + 4 * i);
          tc[4 * i] = t.x, tc[4 * i + 1] = t.y, tc[4 * i + 2] = t.z,
          tc[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* tr = rside + 6 * a;
          const float sr = rside[18 + a];
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float h = j == jd ? rside[21 + 3 * a + e]
                                    : __fmul_rn(__fmul_rn(gg[j], d[a][j]),
                                                d[e][j]);
            v[j] = stitch(h, sr, at(sc4, j), tr, tc + 6 * j);
          }
          __stcs(reinterpret_cast<float4*>(
                     ob + static_cast<size_t>(a * n + p) * mp + c0),
                 make_float4(v[0], v[1], v[2], v[3]));
        }
      }
    }
  } else {
    // per row atom: mp / 4 output column groups of its three rows
    const int groups = mp / 4;
    for (int i = threadIdx.x; i < band * groups; i += kThreads) {
      const int ra = i / groups, c0 = 4 * (i - ra * groups), p = p0 + ra;
      const float* rside = side[ra];
      const float px = col.x[p], py = col.y[p], pz = col.z[p];
      float v[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        if (c >= m) {
#pragma unroll
          for (int a = 0; a < 3; ++a) v[a][j] = 0.0f;
          continue;
        }
        const int e = c / n, q = c - e * n;
        float d[3];
        d[0] = __fsub_rn(px, col.x[q]);
        d[1] = __fsub_rn(py, col.y[q]);
        d[2] = __fsub_rn(pz, col.z[q]);
        const float sq = springcraft::squared_distance(d[0], d[1], d[2]);
        const float g = pair_g(kind, sq, q != p, cutoff_sq, has_cutoff);
        float tc[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) tc[k] = col.ts[c * 6 + k];
        const float sc = col.scale[c];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float h = q == p ? rside[21 + 3 * a + e]
                                 : __fmul_rn(__fmul_rn(g, d[a]), d[e]);
          v[a][j] = stitch(h, rside[18 + a], sc, rside + 6 * a, tc);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
        __stcs(reinterpret_cast<float4*>(
                   ob + static_cast<size_t>(a * n + p) * mp + c0),
               make_float4(v[a][0], v[a][1], v[a][2], v[a][3]));
    }
  }
}

}  // namespace

// Shared memory of a store block: the column side, 24 n floats, then the
// band's row side.
static size_t stitch_smem_bytes(int n) {
  return (24 * static_cast<size_t>(n) + kBandAtoms * kSide) * sizeof(float);
}

extern "C" int sc_assembly_row_sums(const float* coords, float* row_sums,
                                    int batch, int n, int kind,
                                    float cutoff_sq, int has_cutoff,
                                    void* stream) {
  if (batch > 0 && n > 0) {
    const int atoms = kRowSumWarps * kAtomsPerWarp;
    const dim3 grid((n + atoms - 1) / atoms, batch);
    row_sums_kernel<<<grid, 32 * kRowSumWarps, 3 * n * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
        coords, row_sums, n, kind, cutoff_sq, has_cutoff);
  }
  return static_cast<int>(cudaGetLastError());
}

// row_sums: (B, n, 9) from sc_assembly_row_sums.  mp must be a multiple of
// 4 (16-byte stores) and at least 3 n.
extern "C" int sc_assembly_stitch(const float* coords, const float* scale_h,
                                  const float* ts, const float* row_sums,
                                  float* out, int batch, int n, int mp,
                                  int kind, float cutoff_sq, int has_cutoff,
                                  void* stream) {
  if (mp % 4 != 0 || n <= 0 || mp < 3 * n) return cudaErrorInvalidValue;
  if (batch > 0) {
    const int atom_bands = (n + kBandAtoms - 1) / kBandAtoms;
    const int pad_bands = (mp - 3 * n + kPadRows - 1) / kPadRows;
    const dim3 grid(atom_bands + pad_bands, batch);
    const size_t smem = stitch_smem_bytes(n);
    const auto kernel =
        n % 4 == 0 ? stitch_kernel<true> : stitch_kernel<false>;
    const cudaError_t opt = springcraft::allow_shared_memory(kernel, smem);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        coords, scale_h, ts, row_sums, out, n, mp, kind, cutoff_sq,
        has_cutoff, atom_bands);
  }
  return static_cast<int>(cudaGetLastError());
}
