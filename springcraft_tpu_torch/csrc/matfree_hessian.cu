// Matrix-free ANM Hessian apply, Y = H X, without the Hessian: coordinates
// (n, 3) and X (3n, k) in xyz plane layout (row a n + i, column c) to Y of
// the same shape,
//
//   y_i = sum_j g_ij d_ij (d_ij . x_j) - (sum_j g_ij d_ij d_ij^T) x_i,
//   d_ij = r_i - r_j,  g_ij = -k_ij / |d_ij|^2.
//
// Two kernels:
//
// * sc_hessian_apply_pairs replaces springcraft_tpu/ops/matfree.py:807
//   `_sparse_apply_kernel` (K13, reached through
//   `hessian_apply_pallas_sparse`): a gather over the pair CSR that
//   matfree_pairs.cu builds once per set-up (row_ptr, slot j and k_ij of
//   every ordered pair within the cutoff, Morton order).  The TPU kernel
//   multiplied the nine (T, T) planes of every neighbour tile pair on its
//   MXU, under 1% of them within the cutoff; walking those tile pairs on
//   every apply bound this kernel by its instruction rate (2.8e8 tests per
//   apply at n = 30,000 for 1.9e6 pairs).  With the list, what is left is the gather:
//   12 flops per gathered float, so the bound is the P x 3k x 4 bytes of
//   x_j rows read from L2 (X itself is 12 n k bytes and stays there).  The
//   design (pair_gather.cuh): a warp per row and up to 64 columns, lanes on
//   (neighbour, float4 column group), d, |d|^2 and g computed once per pair
//   by the lane that read it and broadcast, the next step's x_j rows in
//   flight during this step's FMAs, the diagonal block D_i summed per lane
//   and y_i -= D_i x_i last, each output row written once, no atomics and
//   no table branch (the constant is in the list).
// * sc_hessian_apply_dense replaces matfree.py:385 `_apply_kernel` (K12,
//   reached through `hessian_apply_pallas`): every pair of the dense grid
//   on every apply, ids = slots, analytic families and the table branch of
//   `table_compact` (codes staged beside the column coordinates, edges in
//   shared memory).  A cutoff-free family passes every pair: 12 k + 30
//   flops per pair, 0.90 ms at n = 10,000, k = 48 at the H100's 67 TFLOP/s.
//   A block of 32 rows covers up to 64 columns (grid.y chunks wider X), so
//   each pair's two divisions run once per apply, and the column atoms
//   come in tiles of 32 whose X rows, coordinates and codes cp.async stages
//   while the tile before is computed.  Per tile, a pair pass computes
//   each pair's test (`pair_passes` of tile_walk.cuh, the pair-CSR
//   build's), g and d once per apply into shared memory, with per row warp
//   masks of the atoms that interact (under a cutoff the others are
//   skipped); after a barrier the FMA pass gives each lane a register tile
//   of 2 rows x 8, 12 or 16 columns, so a float4 of x_j feeds both rows and
//   a pair's values feed all the lane's columns.  What bounds it now: the FMA
//   pass, at a third of the float32 peak over the kernel (2.46 ms against the
//   0.90 ms bound), with the pair pass and its two divisions a pair beside it.
//   These did not beat it: tiles of 3 or 4 rows (fewer shared-memory reads a
//   FMA, registers that cost more in occupancy than they save), 4 x 6 lane
//   tiles, reading the next atom's operands during this one's FMAs, and 3xTF32
//   mma.sync on H planes formed in registers, whose accumulator adds with
//   truncation: run over every k-step its error grew with n past float32's, and
//   the unbiased forms gave back most of the gain.  The 4 blocks of a cluster
//   (grid.z) take alternate column tiles of the same rows and sum their
//   partials through distributed shared memory in a fixed order; y_i -= D_i x_i
//   last, each output written once, no atomics on Y.  A launch may cover a
//   row range [row_start, row_start + n_rows) against every column atom (the
//   row shard of a mesh, parallel/sharded.py): the grid covers the range and
//   Y holds its rows only.  Each row's sums run in the same order wherever
//   the range starts (a pair no row of the lane's warp meets is skipped, one
//   only another row meets adds exact zeros), so a range's rows are bit for
//   bit those of the full call.
//
// Numerics: the pair values (d, |d|^2, k, g) follow the plain versions'
// roundings (spring.cuh); the sums run pair by pair in float32, in another
// order than the plain versions' plane products, so the two agree to a
// stated tolerance, not bit for bit.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_gather.cuh"
#include "spring.cuh"
#include "tile_walk.cuh"

namespace {

using springcraft::kFullMask;

// ---------------------------------------------------------------------------
// K13: the gather over the pair CSR
// ---------------------------------------------------------------------------

// Row i of Y for this warp's lane columns.
template <int VEC, int GPL>
__device__ __forceinline__ void hessian_row(
    int i, const springcraft::LaneColumns<VEC, GPL>& cols, int lane,
    int lpn, const float* __restrict__ coords,
    const int* __restrict__ row_ptr, const int* __restrict__ slots,
    const float* __restrict__ kvals, const float* __restrict__ x,
    float* __restrict__ out, size_t plane, int k) {
  const float px = coords[3 * i], py = coords[3 * i + 1],
              pz = coords[3 * i + 2];

  float y[3][GPL][VEC];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < GPL; ++q)
#pragma unroll
      for (int c = 0; c < VEC; ++c) y[a][q][c] = 0.0f;
  // D_i over the pairs this lane read
  float d00 = 0.0f, d01 = 0.0f, d02 = 0.0f, d11 = 0.0f, d12 = 0.0f,
        d22 = 0.0f;

  const int p1 = row_ptr[i + 1];
  for (int base = row_ptr[i]; base < p1; base += 32) {
    // this lane's pair of the batch; a lane past the end reads row i with
    // g = 0
    int mj = i;
    float mdx = 0.0f, mdy = 0.0f, mdz = 0.0f, mg = 0.0f;
    if (base + lane < p1) {
      mj = slots[base + lane];
      const float kij = kvals[base + lane];
      mdx = __fsub_rn(px, coords[3 * mj]);
      mdy = __fsub_rn(py, coords[3 * mj + 1]);
      mdz = __fsub_rn(pz, coords[3 * mj + 2]);
      const float sq = springcraft::squared_distance(mdx, mdy, mdz);
      mg = -__fdiv_rn(kij, sq == 0.0f ? 1.0f : sq);
      const float gx = mg * mdx, gy = mg * mdy, gz = mg * mdz;
      d00 += gx * mdx;
      d01 += gx * mdy;
      d02 += gx * mdz;
      d11 += gy * mdy;
      d12 += gy * mdz;
      d22 += gz * mdz;
    }
    const int steps = (min(32, p1 - base) + cols.npw - 1) / cols.npw;
    float cur[3][GPL][VEC], nxt[3][GPL][VEC];
    int src = cols.ns;
    {
      const size_t j = __shfl_sync(kFullMask, mj, src);
#pragma unroll
      for (int a = 0; a < 3; ++a) cols.load(x + a * plane + j * k, cur[a]);
    }
    for (int s = 0; s < steps; ++s) {
      const float dx = __shfl_sync(kFullMask, mdx, src);
      const float dy = __shfl_sync(kFullMask, mdy, src);
      const float dz = __shfl_sync(kFullMask, mdz, src);
      const float g = __shfl_sync(kFullMask, mg, src);
      src += cols.npw;
      if (s + 1 < steps) {
        const size_t j = __shfl_sync(kFullMask, mj, src);
#pragma unroll
        for (int a = 0; a < 3; ++a) cols.load(x + a * plane + j * k, nxt[a]);
      }
      const float gx = g * dx, gy = g * dy, gz = g * dz;
#pragma unroll
      for (int q = 0; q < GPL; ++q)
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float t =
              dx * cur[0][q][c] + dy * cur[1][q][c] + dz * cur[2][q][c];
          y[0][q][c] += gx * t;
          y[1][q][c] += gy * t;
          y[2][q][c] += gz * t;
        }
      if (s + 1 < steps) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int q = 0; q < GPL; ++q)
#pragma unroll
            for (int c = 0; c < VEC; ++c) cur[a][q][c] = nxt[a][q][c];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < GPL; ++q)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        y[a][q][c] = springcraft::lane_sum(y[a][q][c], lpn);
  d00 = springcraft::lane_sum(d00, 1);
  d01 = springcraft::lane_sum(d01, 1);
  d02 = springcraft::lane_sum(d02, 1);
  d11 = springcraft::lane_sum(d11, 1);
  d12 = springcraft::lane_sum(d12, 1);
  d22 = springcraft::lane_sum(d22, 1);
  if (cols.ns != 0) return;  // lanes of neighbour 0 write the row
  float xi[3][GPL][VEC];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cols.load(x + a * plane + static_cast<size_t>(i) * k, xi[a]);
#pragma unroll
  for (int q = 0; q < GPL; ++q)
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      const float a0 = xi[0][q][c], a1 = xi[1][q][c], a2 = xi[2][q][c];
      y[0][q][c] -= d00 * a0 + d01 * a1 + d02 * a2;
      y[1][q][c] -= d01 * a0 + d11 * a1 + d12 * a2;
      y[2][q][c] -= d02 * a0 + d12 * a1 + d22 * a2;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    cols.store(out + a * plane + static_cast<size_t>(i) * k, y[a]);
}

// One warp per row (kGatherWarps consecutive rows per block).
template <int VEC, int GPL>
__global__ void __launch_bounds__(springcraft::kGatherThreads)
    hessian_apply_pairs_kernel(const float* __restrict__ coords,
                               const int* __restrict__ row_ptr,
                               const int* __restrict__ slots,
                               const float* __restrict__ kvals,
                               const float* __restrict__ x,
                               float* __restrict__ out, int n, int k,
                               int lpn) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * springcraft::kGatherWarps + threadIdx.x / 32;
  if (i >= n) return;  // whole warp
  hessian_row<VEC, GPL>(i, springcraft::LaneColumns<VEC, GPL>(lane, lpn, k),
                        lane, lpn, coords, row_ptr, slots, kvals, x, out,
                        static_cast<size_t>(n) * k, k);
}

template <int VEC, int GPL>
void launch_pairs(dim3 grid, cudaStream_t stream, const float* coords,
                  const int* row_ptr, const int* slots, const float* kvals,
                  const float* x, float* out, int n, int k, int lpn) {
  hessian_apply_pairs_kernel<VEC, GPL>
      <<<grid, springcraft::kGatherThreads, 0, stream>>>(
          coords, row_ptr, slots, kvals, x, out, n, k, lpn);
}

using LaunchPairs = void (*)(dim3, cudaStream_t, const float*, const int*,
                             const int*, const float*, const float*, float*,
                             int, int, int);
// by [VEC == 4][GPL - 1]
constexpr LaunchPairs kLaunchPairs[2][4] = {
    {&launch_pairs<1, 1>, &launch_pairs<1, 2>, &launch_pairs<1, 3>,
     &launch_pairs<1, 4>},
    {&launch_pairs<4, 1>, &launch_pairs<4, 2>, &launch_pairs<4, 3>,
     &launch_pairs<4, 4>}};

// ---------------------------------------------------------------------------
// K12: the register-tiled apply over every column atom
// ---------------------------------------------------------------------------

namespace dense {

constexpr int kRows = 32;     // row atoms per block, one per lane of a warp
constexpr int kTile = 32;     // column atoms per tile: one mask bit each
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCols = 64;  // columns per block; wider X takes grid.y chunks
constexpr int kStages = 2;    // tiles in flight: this one and the next
// Blocks of a cluster: they split the column atoms of the same rows, which
// evens out the row blocks over the SMs.
constexpr int kCluster = 4;

// The 32-bit mask of bits 0, step, 2 step, ...: shifted left by r, the
// atoms q of a tile with q % step == r.
__host__ __device__ constexpr unsigned every(int step) {
  unsigned m = 0;
  for (int q = 0; q < 32; q += step) m |= 1u << q;
  return m;
}

// One instance: a lane holds RI rows x RC columns of Y (RC a multiple of 4,
// read as float4 from the staged X), LC lanes across the columns.  A warp
// covers kWarpRows rows and all kWidth columns; the kSplit warps on the same
// rows take alternate atoms of each tile.
template <int RI, int LC, int RC>
struct Shape {
  static constexpr int kWidth = LC * RC;
  static constexpr int kLaneRows = 32 / LC;
  static constexpr int kWarpRows = RI * kLaneRows;
  static constexpr int kRowWarps = kRows / kWarpRows;
  static constexpr int kSplit = kWarps / kRowWarps;
  static constexpr int kGroups = RC / 4;
  static_assert(RC % 4 == 0 && kWidth <= kMaxCols, "float4 groups");
  static_assert(kRows % kWarpRows == 0 && kWarps % kRowWarps == 0, "rows");

  // Shared memory, in floats.  Main loop: the X tiles (kStages, 3, kTile,
  // kWidth), the pair values of a tile by (q, row) as float4 (dx, dy, dz,
  // g), the column atoms' coordinates (kStages, 3, kTile) and codes
  // (kStages, kTile), the bin edges, the active-atom masks (kStages,
  // kRowWarps).
  static constexpr int kXStage = 3 * kTile * kWidth;
  static constexpr int kPairs = kStages * kXStage;
  static constexpr int kCoords = kPairs + 4 * kTile * kRows;
  static constexpr int kCodes = kCoords + kStages * 3 * kTile;
  static constexpr int kEdges = kCodes + kStages * kTile;
  static constexpr int kMasks = kEdges + springcraft::kMaxEdges;
  static constexpr int kMain = kMasks + kStages * kRowWarps;
  // Epilogue, over the same memory: each warp's partial Y (kSplit, 3,
  // kRows, kWidth), each warp's partial D (kWarps, 6, kRows), the block's D
  // (6, kRows).
  static constexpr int kDPart = kSplit * 3 * kRows * kWidth;
  static constexpr int kDSum = kDPart + kWarps * 6 * kRows;
  static constexpr int kEpilogue = kDSum + 6 * kRows;
  static constexpr size_t kBytes =
      sizeof(float) * (kMain > kEpilogue ? kMain : kEpilogue);
};

// Where D's entry (a, b) lies among (00, 01, 02, 11, 12, 22).
__device__ __forceinline__ int entry(int a, int b) {
  const int lo = min(a, b), hi = max(a, b);
  return lo == 0 ? hi : lo == 1 ? 2 + hi : 5;
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [row_start + 32 x, row_start + 32 x + 32) of Y, clipped to
// row_end, and its columns [c0, c0 + kc), c0 = blockIdx.y width; the
// cluster's blocks (grid.z) take alternate column tiles and sum their
// partials through distributed shared memory.  Y holds the rows [row_start,
// row_end) of each plane (plane stride (row_end - row_start) k); column
// atoms, X and the diagonal's x_i stay global.  `vec`: X and k allow
// 16-byte copies.  MB: blocks per SM the registers are capped for.
template <bool kTable, int RI, int LC, int RC, int MB>
__global__ void __launch_bounds__(kThreads, MB)
    hessian_apply_dense_kernel(const float* __restrict__ coords,
                               const float* __restrict__ x,
                               float* __restrict__ out, int n, int k,
                               int row_start, int row_end, int width,
                               int vec, int kind, float cutoff_sq,
                               int has_cutoff, springcraft::PairTable table,
                               const float* __restrict__ edges_sq,
                               const int* __restrict__ atom_code) {
  using S = Shape<RI, LC, RC>;
  namespace cg = cooperative_groups;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float4* const pairs = reinterpret_cast<float4*>(smem + S::kPairs);
  unsigned* const masks = reinterpret_cast<unsigned*>(smem + S::kMasks);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int splits = kCluster;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = row_start + blockIdx.x * kRows;
  const int c0 = blockIdx.y * width, kc = min(width, k - c0);
  const size_t plane = static_cast<size_t>(n) * k;
  const size_t out_plane = static_cast<size_t>(row_end - row_start) * k;
  const int n_tiles = (n + kTile - 1) / kTile;

  if constexpr (kTable) {
    float* const edges = smem + S::kEdges;
    for (int e = tid; e < table.n_edges; e += kThreads)
      edges[e] = edges_sq[e];
    table.edges_sq = edges;
  }
  if (tid < kStages * S::kRowWarps) masks[tid] = 0;

  // The pair pass: lane = row, warp w takes the tile's atoms q = w, w + 4,
  // ..., and sums the lane's share of D_i.
  const int gi = row0 + lane;
  const bool row_ok = gi < row_end;
  springcraft::WalkRow row{0.0f, 0.0f, 0.0f, n, 0};
  if (row_ok)
    row = springcraft::WalkRow{coords[3 * gi], coords[3 * gi + 1],
                               coords[3 * gi + 2], gi,
                               kTable ? atom_code[gi] : 0};
  float d00 = 0.0f, d01 = 0.0f, d02 = 0.0f, d11 = 0.0f, d12 = 0.0f,
        d22 = 0.0f;

  // The FMA pass: warp (rw, js) holds rows rw kWarpRows + lr + kLaneRows ai
  // and columns 4 (lc + LC g) + 0..3.
  const int rw = warp % S::kRowWarps, js = warp / S::kRowWarps;
  const int lr = lane % S::kLaneRows, lc = lane / S::kLaneRows;
  const int rbase = rw * S::kWarpRows + lr;
  const unsigned mine = every(S::kSplit) << js;
  float y[3][RI][RC];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int ai = 0; ai < RI; ++ai)
#pragma unroll
      for (int c = 0; c < RC; ++c) y[a][ai][c] = 0.0f;

  // The copy of a tile's X rows walks (row, group of `step` floats) from
  // this thread's start, kThreads groups at a time; the atoms' coordinates
  // (and codes) come with them.
  const int step = vec ? 4 : 1;
  const int groups = (kc + step - 1) / step;
  const int r_first = tid / groups, g_first = tid - r_first * groups;
  const int r_step = kThreads / groups, g_step = kThreads - r_step * groups;
  auto stage = [&](int t, int slot) {
    const int j0 = t * kTile, len = min(kTile, n - j0);
    float* const cdst = smem + S::kCoords + slot * 3 * kTile;
    for (int e = tid; e < 3 * len; e += kThreads) {
      const int atom = e / 3;
      cp_async_4(cdst + (e - 3 * atom) * kTile + atom, coords + 3 * j0 + e);
    }
    if constexpr (kTable)
      for (int e = tid; e < len; e += kThreads)
        cp_async_4(smem + S::kCodes + slot * kTile + e, atom_code + j0 + e);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* src = x + (static_cast<size_t>(a) * n + j0) * k + c0;
      float* dst = smem + slot * S::kXStage + a * kTile * S::kWidth;
      for (int r = r_first, g = g_first; r < len;) {
        if (vec)
          cp_async_16(dst + r * S::kWidth + 4 * g,
                      src + static_cast<size_t>(r) * k + 4 * g);
        else
          cp_async_4(dst + r * S::kWidth + g,
                     src + static_cast<size_t>(r) * k + g);
        r += r_step;
        g += g_step;
        if (g >= groups) {
          g -= groups;
          ++r;
        }
      }
    }
  };

  // Pair p of this lane (row) in tile t: atom q = warp + kWarps p.  Writes
  // d and g when some row of the block interacts with q (zeros for the rows
  // that do not), adds to this lane's D_i, and marks q in `bits` for the
  // row warps whose rows interact with it.  The analytic constant is
  // computed by every lane and then masked, so no branch separates the
  // lane's pairs.
  auto pair_values = [&](int p, int t, int slot,
                         unsigned (&bits)[S::kRowWarps]) {
    const int q = warp + kWarps * p, jid = t * kTile + q;
    const float* cx = smem + S::kCoords + slot * 3 * kTile;
    float dx, dy, dz;
    const float sq = springcraft::pair_geometry(
        row, cx[q], cx[kTile + q], cx[2 * kTile + q], dx, dy, dz);
    const bool pass = row_ok && springcraft::pair_passes(
                                    row, jid, n, sq, cutoff_sq, has_cutoff);
    float g = 0.0f;
    if constexpr (kTable) {
      if (pass) {
        const int jcode = reinterpret_cast<const int*>(
            smem + S::kCodes + slot * kTile)[q];
        g = -__fdiv_rn(springcraft::table_constant(table, row.code, jcode,
                                                   row.id, jid, sq),
                       sq == 0.0f ? 1.0f : sq);
      }
    } else {
      g = -__fdiv_rn(springcraft::spring_constant(kind, sq),
                     sq == 0.0f ? 1.0f : sq);
    }
    const unsigned b = __ballot_sync(kFullMask, pass);
    if (b == 0) return;  // no row of the block: never read
    if (!pass) g = dx = dy = dz = 0.0f;
    const float gx = g * dx, gy = g * dy, gz = g * dz;
    d00 += gx * dx;
    d01 += gx * dy;
    d02 += gx * dz;
    d11 += gy * dy;
    d12 += gy * dz;
    d22 += gz * dz;
    pairs[q * kRows + lane] = make_float4(dx, dy, dz, g);
#pragma unroll
    for (int r = 0; r < S::kRowWarps; ++r) {
      const unsigned rows = S::kWarpRows == 32
                                ? kFullMask
                                : ((1u << S::kWarpRows) - 1)
                                      << (r * S::kWarpRows);
      if (b & rows) bits[r] |= 1u << q;
    }
  };

  // y += g d (d . x_q) for atom q of the tile in X stage `slot`
  auto accumulate = [&](int q, int slot) {
    float4 pv[RI];
    float gx[RI], gy[RI], gz[RI];
#pragma unroll
    for (int ai = 0; ai < RI; ++ai) {
      pv[ai] = pairs[q * kRows + rbase + S::kLaneRows * ai];
      gx[ai] = pv[ai].w * pv[ai].x;
      gy[ai] = pv[ai].w * pv[ai].y;
      gz[ai] = pv[ai].w * pv[ai].z;
    }
    const float4* xt =
        reinterpret_cast<const float4*>(smem + slot * S::kXStage);
#pragma unroll
    for (int g = 0; g < S::kGroups; ++g) {
      const int col = q * (S::kWidth / 4) + lc + LC * g;
      const float4 x0 = xt[col];
      const float4 x1 = xt[kTile * (S::kWidth / 4) + col];
      const float4 x2 = xt[2 * kTile * (S::kWidth / 4) + col];
      const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
      const float a2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
      for (int ai = 0; ai < RI; ++ai)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float tt =
              pv[ai].x * a0[c] + pv[ai].y * a1[c] + pv[ai].z * a2[c];
          y[0][ai][4 * g + c] += gx[ai] * tt;
          y[1][ai][4 * g + c] += gy[ai] * tt;
          y[2][ai][4 * g + c] += gz[ai] * tt;
        }
    }
  };

  // Per tile: its pair pass, a barrier, its FMA pass, while the next tile's
  // atoms and X rows are in flight.
  int t = rank;
  if (t < n_tiles) stage(t, 0);
  cp_async_commit();
  for (int it = 0; t < n_tiles; t += splits, ++it) {
    const int s = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile's FMA pass is done
    if (t + splits < n_tiles) stage(t + splits, s ^ 1);
    cp_async_commit();
    unsigned bits[S::kRowWarps] = {};
#pragma unroll
    for (int p = 0; p < kTile / kWarps; ++p) pair_values(p, t, s, bits);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < S::kRowWarps; ++r)
        if (bits[r]) atomicOr(&masks[s * S::kRowWarps + r], bits[r]);
    if (tid < S::kRowWarps) masks[(s ^ 1) * S::kRowWarps + tid] = 0;
    __syncthreads();  // the pair values and masks of tile t
    for (unsigned m = masks[s * S::kRowWarps + rw] & mine; m; m &= m - 1)
      accumulate(__ffs(m) - 1, s);
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is out of the main loop's memory

  // Epilogue: partials to shared memory, summed over the warps and the
  // cluster in a fixed order; y_i -= D_i x_i; each output written once.
  float* const ypart = smem;
  float* const dpart = smem + S::kDPart;
  float* const dsum = smem + S::kDSum;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int ai = 0; ai < RI; ++ai)
#pragma unroll
      for (int g = 0; g < S::kGroups; ++g)
        *reinterpret_cast<float4*>(
            ypart + ((js * 3 + a) * kRows + rbase + S::kLaneRows * ai) *
                        S::kWidth +
            4 * (lc + LC * g)) =
            make_float4(y[a][ai][4 * g], y[a][ai][4 * g + 1],
                        y[a][ai][4 * g + 2], y[a][ai][4 * g + 3]);
  const float dl[6] = {d00, d01, d02, d11, d12, d22};
#pragma unroll
  for (int e = 0; e < 6; ++e) dpart[(warp * 6 + e) * kRows + lane] = dl[e];
  __syncthreads();
  cluster.sync();
  for (int e = tid; e < 6 * kRows; e += kThreads) {
    float sum = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* dp = cluster.map_shared_rank(dpart, r);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += dp[w * 6 * kRows + e];
    }
    dsum[e] = sum;
  }
  __syncthreads();
  for (int u = rank * kThreads + tid; u < 3 * kRows * S::kWidth;
       u += splits * kThreads) {
    const int a = u / (kRows * S::kWidth);
    const int rem = u - a * kRows * S::kWidth;
    const int rr = rem / S::kWidth, c = rem - rr * S::kWidth;
    const int i = row0 + rr;
    if (i >= row_end || c >= kc) continue;
    float sum = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* yp = cluster.map_shared_rank(ypart, r);
#pragma unroll
      for (int h = 0; h < S::kSplit; ++h)
        sum += yp[(h * 3 + a) * kRows * S::kWidth + rem];
    }
    const float* xi = x + static_cast<size_t>(i) * k + c0 + c;
    const float e0 = dsum[entry(a, 0) * kRows + rr];
    const float e1 = dsum[entry(a, 1) * kRows + rr];
    const float e2 = dsum[entry(a, 2) * kRows + rr];
    out[a * out_plane + static_cast<size_t>(i - row_start) * k + c0 + c] =
        sum - (e0 * xi[0] + e1 * xi[plane] + e2 * xi[2 * plane]);
  }
  cluster.sync();  // no block leaves while the others read its memory
}

template <bool kTable, int RI, int LC, int RC, int MB>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* coords,
                   const float* x, float* out, int n, int k, int row_start,
                   int row_end, int width, int vec, int kind,
                   float cutoff_sq, int has_cutoff,
                   springcraft::PairTable table, const float* edges_sq,
                   const int* atom_code) {
  const auto kernel = hessian_apply_dense_kernel<kTable, RI, LC, RC, MB>;
  const size_t bytes = Shape<RI, LC, RC>::kBytes;
  const cudaError_t err = springcraft::allow_shared_memory(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = kCluster;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, coords, x, out, n, k, row_start,
                            row_end, width, vec, kind, cutoff_sq, has_cutoff,
                            table, edges_sq, atom_code);
}

using Launch = cudaError_t (*)(dim3, cudaStream_t, const float*,
                               const float*, float*, int, int, int, int, int,
                               int, int, float, int, springcraft::PairTable,
                               const float*, const int*);
// by [kTable][width <= 16, 32, 48, 64]
constexpr Launch kLaunch[2][4] = {
    {&launch<false, 2, 2, 8, 4>, &launch<false, 2, 4, 8, 4>,
     &launch<false, 2, 4, 12, 4>, &launch<false, 2, 4, 16, 3>},
    {&launch<true, 2, 2, 8, 4>, &launch<true, 2, 4, 8, 4>,
     &launch<true, 2, 4, 12, 3>, &launch<true, 2, 4, 16, 3>}};

}  // namespace dense

}  // namespace

// The pair CSR of matfree_pairs.cu: row_ptr (n + 1), slots and k (P).
extern "C" int sc_hessian_apply_pairs(const float* coords, const int* row_ptr,
                                      const int* slots, const float* kvals,
                                      const float* x, float* out, int n,
                                      int k, void* stream) {
  if (n > 0 && k > 0) {
    const springcraft::GatherShape s = springcraft::gather_shape(k, x, out);
    const dim3 grid(
        (n + springcraft::kGatherWarps - 1) / springcraft::kGatherWarps,
        (k + springcraft::kGatherCols - 1) / springcraft::kGatherCols);
    kLaunchPairs[s.vec == 4][s.gpl - 1](
        grid, static_cast<cudaStream_t>(stream), coords, row_ptr, slots,
        kvals, x, out, n, k, s.lpn);
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows [row_start, row_start + n_rows) of Y = H X: out is (3, n_rows, k)
// (the full range: (3n, k)), X (3n, k) and the coordinates (n, 3) are
// whole.  tables (n_bins, 3, 20, 20), edges_sq (n_edges <= kMaxEdges) and
// atom_code (n) are read only for kind == table_compact and may be null
// otherwise.
extern "C" int sc_hessian_apply_dense(const float* coords, const float* x,
                                      float* out, int n, int k, int row_start,
                                      int n_rows, int kind,
                                      float cutoff_sq, int has_cutoff,
                                      const float* tables,
                                      const float* edges_sq,
                                      const int* atom_code, int n_bins,
                                      int n_edges, void* stream) {
  if (n_edges > springcraft::kMaxEdges || row_start < 0 || n_rows < 0 ||
      row_start > n - n_rows)
    return cudaErrorInvalidValue;
  if (n_rows > 0 && k > 0) {
    // the widest column chunks of at most 64 (a multiple of 4 where k is)
    const int chunks = (k + dense::kMaxCols - 1) / dense::kMaxCols;
    int width = (k + chunks - 1) / chunks;
    const bool vec4 = k % 4 == 0;
    if (vec4) width = (width + 3) / 4 * 4;
    const int vec =
        vec4 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0 ? 1 : 0;
    const dim3 grid((n_rows + dense::kRows - 1) / dense::kRows, chunks,
                    dense::kCluster);
    const int shape = width <= 16 ? 0 : width <= 32 ? 1 : width <= 48 ? 2 : 3;
    const springcraft::PairTable table{tables, nullptr, n_bins, n_edges};
    const cudaError_t err = dense::kLaunch[kind == springcraft::kTableCompact]
                                          [shape](
        grid, static_cast<cudaStream_t>(stream), coords, x, out, n, k,
        row_start, row_start + n_rows, width, vec, kind, cutoff_sq, has_cutoff,
        table, edges_sq, atom_code);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
