// The solve pair of a Cholesky factor: X = S L^-T L^-1 S B for a lower
// factor L (m x m, column-major, leading dimension ldl: the storage
// torch.linalg.cholesky_ex returns, read where it lies; ldl a multiple of
// 16 bytes, else ops/spd_linalg.py chol_solve_factor copies the factor
// once, padded), a right-hand side
// B (m x b, any strides) and a diagonal scaling S, as one forward launch
// (L Y = S B) and one backward launch (L^T X = Y, then S X).
//
// Replaces no TPU kernel.  The JAX package applies the inverse of its
// Cholesky shift-invert engine with jax.scipy.linalg.cho_solve
// (springcraft_tpu/ops/modes.py:253), which XLA lowers to its own
// triangular solves; the port's `_chol_inverse` (ops/modes.py) called
// torch.cholesky_solve, which copies its factor on every call and runs
// cuBLAS trsm at about a tenth of its bound at (m 30,000, b 48).
//
// What bounds a solve on the H100: the factor's triangle, m (m + 1) / 2
// values read once (1.8 GB at m = 30,000 in float32: 0.54 ms at 3.35
// TB/s), and m^2 b multiply-adds (0.65 ms at 67 TFLOP/s f32): both about
// equal, so the triangle has to stream at full rate while the CUDA cores
// stay busy on it.  Beside that runs the chain of diagonal blocks, which
// is sequential.
//
// The design.  Rows go in row blocks of kNb = 64, in solve order (forward
// ascending, backward descending); "ticket" t is the t-th row block of
// that order.  One launch is persistent, one block of 256 threads an SM.
// The first block to start takes the chain: for each ticket t in turn it
// takes the row block's partial sum P_t (loaded while it multiplies),
// subtracts the product of the last off-diagonal tile with X_{t-1} (kept
// in shared memory from its previous step), solves the 64 x 64 diagonal
// block by blocked substitution (sub-blocks of 16 rows, each solved by one
// thread a right-hand-side column, the rows below updated by 128 threads;
// a row's updates summed apart and taken from it once, so that they round
// at their own scale), writes X_t and releases its ready flag; 64 threads
// prefetch the next step's tile and diagonal block meanwhile.
// Every other block draws tickets from an atomic counter and computes
// P_t = S B_t - sum_{u < t - 1} L_tu X_u over u = 0, 1, ..., t - 2 in
// that fixed order: each 64 x 64 tile of L (a contiguous run of 64 values
// a column, in 16-byte cp.async copies: the leading dimension is a
// multiple of 16 bytes) and the 64 x b block
// X_u (from L2, written by the chain) stream through a ring of kStages
// shared-memory stages; X_u waits on the ready flag of ticket u
// (st.release / ld.acquire at gpu scope), and a stage whose flag was not
// set when the stage was filled loads X_u when it is consumed.  The two
// halves of the block take the two halves of a tile's 64 terms, 128
// threads a half multiply-adding 4 rows x kCw columns each, a tile's terms
// summed apart and then added to the row block's sum.  A tile's columns
// lie in shared memory with their 16-byte chunks permuted by an XOR of the
// column's low bits, so that the backward solve's reads across columns
// fall on distinct banks.  P_t goes to a buffer and its own flag.  A row
// block waits only on tickets already drawn by running blocks, and the
// chain, if it finds its next row block not yet drawn, draws and computes
// it itself, so no block waits on one that has not started: the kernel
// cannot deadlock, whatever the residency.  Far from the chain a row
// block's tiles are done long before its turn, so the triangle streams
// while the chain runs.  The backward
// solve is the same over L^T: its tile for (t, u) is the column block of
// t at the rows of u's block, again 64 contiguous values a column, read
// as the transpose in the multiply-adds; its diagonal substitution takes
// dot products over the same storage.  Every value is summed in a fixed
// order, so the result is the same bit for bit whatever the scheduling.
// The backward's output S X is written by the blocks that find no ticket
// left, row block by row block as the chain releases them, off its path.
// The last block to leave resets the counters and the flags, so the next
// launch on the stream needs no memset.  Float32 arithmetic is plain FMA
// on the CUDA cores (no TF32); the template also runs in float64.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNb = 64;         // rows of a row block
constexpr int kHalf = 128;      // threads of a half: 16 row groups x 8
constexpr int kThreads = 2 * kHalf;
constexpr int kCw = 6;          // right-hand-side columns of a thread
constexpr int kMaxColumns = 8 * kCw;

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kStages = 4;
  static constexpr int kChainSets = 2;
  using Vec2 = float2;
};
template <>
struct Traits<double> {
  static constexpr int kStages = 2;
  static constexpr int kChainSets = 1;
  using Vec2 = double2;
};

// Shared memory of one block, in elements of T.  A ring that holds either
// the streaming stages (an L tile and an X block each) or the chain's
// prefetch sets (the off-diagonal tile, the diagonal block, the partial);
// the row block's right-hand side; the chain's X_{t-1} and X_t; the other
// half's sums (in the substitution, the rows' update sums); the inverse of
// the diagonal.
template <typename T>
struct Layout {
  static constexpr int kBp = kMaxColumns;  // columns of the work buffers
  static constexpr int kStages = Traits<T>::kStages;
  static constexpr int kSets = Traits<T>::kChainSets;
  static constexpr int kTile = kNb * kNb;
  static constexpr int kRhs = kNb * kBp;
  static constexpr int kStage = kTile + kRhs;
  static constexpr int kSet = 2 * kTile + kRhs;
  static constexpr int kRing =
      kStages * kStage > kSets * kSet ? kStages * kStage : kSets * kSet;
  static constexpr int kOwn = kRing;
  static constexpr int kX = kOwn + kRhs;  // two buffers
  static constexpr int kRed = kX + 2 * kRhs;
  static constexpr int kInv = kRed + kRhs;
  static constexpr int kEnd = kInv + kNb;
  static constexpr size_t kBytes = sizeof(T) * kEnd;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void wait_flag(const int* p) {
  while (ld_acquire(p) == 0) __nanosleep(32);
}

// 16 bytes, from L2 (never L1: the work buffers are written by other
// blocks during the launch); `bytes` below 16 fills the rest with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Named barrier `id` of `count` threads: wait for it, or arrive at it.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// A thread's kCw consecutive right-hand-side columns of one row.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, T (&v)[kCw]) {
  using Vec2 = typename Traits<T>::Vec2;
#pragma unroll
  for (int q = 0; q < kCw; q += 2) {
    const Vec2 w = *reinterpret_cast<const Vec2*>(p + q);
    v[q] = w.x;
    v[q + 1] = w.y;
  }
}

template <typename T>
__device__ __forceinline__ void store_cols(T* p, const T (&v)[kCw]) {
  using Vec2 = typename Traits<T>::Vec2;
#pragma unroll
  for (int q = 0; q < kCw; q += 2) {
    Vec2 w;
    w.x = v[q];
    w.y = v[q + 1];
    *reinterpret_cast<Vec2*>(p + q) = w;
  }
}

struct Args {
  const void* l;  // the factor, column-major
  long long ldl;
  int m;
  int n_rb;
  const void* src;
  long long src_rs, src_cs;
  int b;              // right-hand-side columns (at most kMaxColumns)
  const void* scale;  // S: the forward's input S B, the backward's S X
  void* part;         // (n_rb kNb, kMaxColumns) row-major: the partial sums
  void* work;         // the same: this solve's result
  void* dst;          // the backward's (m, b), rows dst_rs apart: S X
  long long dst_rs;
  // ticket, exit count, chain owner, output ticket, a ready flag a
  // ticket, a partial flag a ticket: zero between launches
  int* ws;
};

enum : int { kReady = 1, kClaimed = 2 };

template <typename T, bool kForward>
struct Solver {
  using L = Layout<T>;
  static constexpr int kBp = L::kBp;
  static constexpr int kStages = L::kStages;
  static constexpr int kSub = 16;  // rows of a substitution sub-block

  const Args& a;
  T* smem;
  int* s_word;  // shared: the ticket, the partial's state
  unsigned* s_ready;
  const int tid, half, r0, c0;

  __device__ Solver(const Args& args, T* sm, int* word, unsigned* ready)
      : a(args),
        smem(sm),
        s_word(word),
        s_ready(ready),
        tid(threadIdx.x),
        half(threadIdx.x / kHalf),
        r0((threadIdx.x % kHalf >> 3) * 4),
        c0((threadIdx.x & 7) * kCw) {}

  // Where tile[c][r] lies: in column c, its 16-byte chunks permuted by an
  // XOR of c's low bits, so that the reads across columns (the backward
  // solve's products and updates) fall on distinct banks.
  __device__ static int at(int c, int r) {
    return c * kNb + (r ^ ((((c >> 2) ^ c) & 3) << 2));
  }

  __device__ int* flags() const { return a.ws + 4; }
  __device__ int* pflags() const { return a.ws + 4 + a.n_rb; }
  __device__ int block_of(int t) const {
    return kForward ? t : a.n_rb - 1 - t;
  }

  // The 64 x 64 tile of L at rows rb kNb.., columns cb kNb.. into `tile`
  // as tile[c][r] = L[rb kNb + r, cb kNb + c] (at `at`), zero past m; by
  // `lanes` threads, this one the idx-th (all threads by default).  A
  // column's run of 64 values goes in 16-byte copies, the last one astride
  // row m taking only the rows above it.
  __device__ void issue_tile(T* tile, int rb, int cb, int idx = -1,
                             int lanes = kThreads) const {
    if (idx < 0) idx = tid;
    constexpr int kV = 16 / sizeof(T);
    constexpr int kPerCol = kNb / kV;
    const T* l = static_cast<const T*>(a.l);
    const int r_base = rb * kNb, c_base = cb * kNb;
#pragma unroll
    for (int q = idx; q < kNb * kPerCol; q += lanes) {
      const int c = q / kPerCol, r = (q % kPerCol) * kV;
      const int gr = r_base + r, gc = c_base + c;
      const int rows = gc < a.m ? min(a.m - gr, kV) : 0;
      const T* p = rows > 0 ? l + static_cast<long long>(gc) * a.ldl + gr : l;
      cp_async_16(tile + at(c, r), p,
                  rows > 0 ? rows * static_cast<int>(sizeof(T)) : 0);
    }
  }

  // The row block `blk` of a (n_rb kNb, kBp) buffer written in this launch.
  __device__ void issue_block(T* dst, const void* buffer, int blk) const {
    const T* src = static_cast<const T*>(buffer) +
                   static_cast<long long>(blk) * L::kRhs;
    constexpr int kV = 16 / sizeof(T);
#pragma unroll
    for (int q = tid; q < L::kRhs / kV; q += kThreads)
      cp_async_16(dst + q * kV, src + q * kV, 16);
  }

  // The tile that couples ticket t to ticket u < t.
  __device__ void issue_coupling(T* tile, int t, int u) const {
    if (kForward)
      issue_tile(tile, block_of(t), block_of(u));
    else
      issue_tile(tile, block_of(u), block_of(t));
  }

  // acc += the product of a tile with an X block over this half's 32
  // terms: a thread's 4 rows x kCw columns, the tile's terms summed apart
  // first and then added to acc, with Kahan's compensation `comp` when
  // kCompensated (the streaming sums over up to n_rb tiles).
  template <bool kCompensated>
  __device__ void multiply(const T* tile, const T* x, T (&acc)[4][kCw],
                           T (&comp)[4][kCw]) const {
    T sum[4][kCw];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < kCw; ++q) sum[i][q] = T(0);
    const int k0 = half * (kNb / 2);
    if constexpr (kForward) {
      // sum[r] += sum_k L_tu[r][k] X_u[k]: tile[k][r]
#pragma unroll 8
      for (int k = k0; k < k0 + kNb / 2; ++k) {
        T lv[4], xv[kCw];
        load4(tile + at(k, r0), lv);
        load_cols<T>(x + k * kBp + c0, xv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < kCw; ++q)
            sum[i][q] = fma(lv[i], xv[q], sum[i][q]);
      }
    } else {
      // sum[c] += sum_k L_ut[k][c] X_u[k]: tile[c][k]
#pragma unroll 2
      for (int k = k0; k < k0 + kNb / 2; k += 4) {
        T lv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load4(tile + at(r0 + i, k), lv[i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          T xv[kCw];
          load_cols<T>(x + (k + kk) * kBp + c0, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < kCw; ++q)
              sum[i][q] = fma(lv[i][kk], xv[q], sum[i][q]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < kCw; ++q) {
        if constexpr (kCompensated) {
          const T y = sum[i][q] - comp[i][q];
          const T s = acc[i][q] + y;
          comp[i][q] = (s - acc[i][q]) - y;
          acc[i][q] = s;
        } else {
          acc[i][q] += sum[i][q];
        }
      }
  }

  // out = in - (the first half's acc + the second half's), over a thread's
  // 4 rows x kCw columns; ends with a barrier.
  __device__ void subtract(const T* in, T* out, const T (&acc)[4][kCw]) const {
    T* red = smem + L::kRed;
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store_cols<T>(red + (r0 + i) * kBp + c0, acc[i]);
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T v[kCw], w[kCw];
        load_cols<T>(in + (r0 + i) * kBp + c0, v);
        load_cols<T>(red + (r0 + i) * kBp + c0, w);
#pragma unroll
        for (int q = 0; q < kCw; ++q) v[q] = v[q] - (acc[i][q] + w[q]);
        store_cols<T>(out + (r0 + i) * kBp + c0, v);
      }
    }
    __syncthreads();
  }

  // A (kNb, kBp) block from shared memory to a global buffer's row block.
  __device__ void store_block(void* buffer, int blk, const T* from) const {
    constexpr int kV = 16 / sizeof(T);
    T* w = static_cast<T*>(buffer) + static_cast<long long>(blk) * L::kRhs;
#pragma unroll
    for (int q = tid; q < L::kRhs / kV; q += kThreads)
      *reinterpret_cast<float4*>(w + q * kV) =
          *reinterpret_cast<const float4*>(from + q * kV);
  }

  // Ticket t's partial sum P_t to the partial buffer, then its flag.
  __device__ void partial(int t) const {
    T* own = smem + L::kOwn;
    const int blk = block_of(t), row0 = blk * kNb, m = a.m;
    const int n_t = t > 1 ? t - 1 : 0;  // tiles u = 0 .. t - 2
    const T* src = static_cast<const T*>(a.src);
    const T* scale = static_cast<const T*>(a.scale);
    // the tickets of the first stages that are done already
    if (tid == 0) {
      unsigned bits = 0;
      for (int s = 0; s < kStages - 1 && s < n_t; ++s)
        if (ld_acquire(flags() + s)) bits |= 1u << s;
      s_ready[0] = bits;
    }
    // the row block's right-hand side (the forward's scaled), zero past m
    // and b
    for (int e = tid; e < L::kRhs; e += kThreads) {
      int r, c;
      if (a.src_cs == 1) {
        r = e / kBp;
        c = e % kBp;
      } else {
        r = e % kNb;
        c = e / kNb;
      }
      const int gr = row0 + r;
      T v = T(0);
      if (gr < m && c < a.b) {
        v = src[gr * a.src_rs + c * a.src_cs];
        if constexpr (kForward) v *= scale[gr];
      }
      own[r * kBp + c] = v;
    }
    __syncthreads();

    unsigned pending = 0;  // stages whose X block waits on its flag
    {
      const unsigned ready = s_ready[0];
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_t) {
          T* stage = smem + s * L::kStage;
          issue_coupling(stage, t, s);
          if (ready >> s & 1)
            issue_block(stage + L::kTile, a.work, block_of(s));
          else
            pending |= 1u << s;
        }
        cp_async_commit();
      }
    }
    T acc[4][kCw], comp[4][kCw];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < kCw; ++q) acc[i][q] = comp[i][q] = T(0);

    for (int u = 0; u < n_t; ++u) {
      const int un = u + kStages - 1;  // the ticket to prefetch now
      const int slot = (u + 1) & 1;
      if (tid == 0) s_ready[slot] = un < n_t ? ld_acquire(flags() + un) : 0;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (un < n_t) {
        T* stage = smem + (un % kStages) * L::kStage;
        issue_coupling(stage, t, un);
        if (s_ready[slot])
          issue_block(stage + L::kTile, a.work, block_of(un));
        else
          pending |= 1u << (un % kStages);
      }
      cp_async_commit();
      const int s = u % kStages;
      T* stage = smem + s * L::kStage;
      if (pending >> s & 1) {
        // not done when the stage was filled: wait for it now
        if (tid == 0) wait_flag(flags() + u);
        __syncthreads();
        issue_block(stage + L::kTile, a.work, block_of(u));
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        pending &= ~(1u << s);
      }
      multiply<true>(stage, stage + L::kTile, acc, comp);
    }
    cp_async_wait<0>();
    subtract(own, own, acc);
    store_block(a.part, blk, own);
    __syncthreads();
    if (tid == 0) st_release(pflags() + t, 1);
  }

  // The chain's step t needs P_t: kReady once its flag is set, kClaimed if
  // no block had drawn ticket t (the chain draws it and computes P_t).
  __device__ int await_partial(int t) const {
    if (tid == 0) {
      int state;
      for (;;) {
        if (ld_acquire(pflags() + t)) {
          state = kReady;
          break;
        }
        if (*reinterpret_cast<volatile int*>(a.ws) == t &&
            atomicCAS(a.ws, t, t + 1) == t) {
          state = kClaimed;
          break;
        }
        __nanosleep(32);
      }
      s_word[1] = state;
    }
    __syncthreads();
    return s_word[1];
  }

  // The chain's tiles of step t into a prefetch set: the coupling tile to
  // ticket t - 1 and the diagonal block.
  __device__ void issue_step(int t, T* set, int idx = -1,
                             int lanes = kThreads) const {
    if (t > 0) {
      if (kForward)
        issue_tile(set, block_of(t), block_of(t - 1), idx, lanes);
      else
        issue_tile(set, block_of(t - 1), block_of(t), idx, lanes);
    }
    issue_tile(set + L::kTile, block_of(t), block_of(t), idx, lanes);
  }

  // Blocked substitution of the chain's z block x (64 x kBp) with the
  // diagonal block diag (tile[c][r] = L[r][c]), inv[p] = 1 / L[p][p], in four
  // sub-blocks of 16 rows, pipelined over three groups of warps:
  // * warps 0 and 1 solve a sub-block, one thread a column, once its rows
  //   have the updates of the sub-blocks solved before it;
  // * warps 2, 3, 6 and 7 (the SM's other two schedulers) then update the
  //   next sub-block's rows first, release them, and update the rest while
  //   that sub-block is solved; a thread owns one row of each sub-block
  //   and kCw columns, so each value takes its updates in solve order;
  // * warps 4 and 5 issue the tiles of step `next` into `set` (next < 0:
  //   none); each thread commits one group.
  // The updates of a row are summed apart from z, in `upd` (the other
  // half's buffer, free here), and taken from z once, when the row is
  // solved: a sum of small terms rounds at its own scale, not at z's.
  // Named barriers 1-3 signal a solved sub-block, 4-6 released rows.
  static constexpr int kPipe = 192;  // threads of the solvers and updaters

  __device__ void substitute(const T* diag, const T* inv, T* x, int next,
                             T* set) const {
    static_assert(kBp <= 64, "the solvers are warps 0 and 1");
    constexpr int kBlocks = kNb / kSub;
    T* upd = smem + L::kRed;
    const int warp = tid >> 5;
    if (warp == 4 || warp == 5) {
      if (next >= 0) issue_step(next, set, tid - 128, 64);
      cp_async_commit();
    } else if (warp < 2) {
      cp_async_commit();
#pragma unroll
      for (int k = 0; k < kBlocks; ++k) {
        if (k > 0) bar_sync(3 + k, kPipe);
        if (tid < kBp) solve_sub_block(diag, inv, x, upd, sub_row(k), k == 0);
        if (k < kBlocks - 1) bar_arrive(1 + k, kPipe);
      }
    } else {
      cp_async_commit();
      const int ui = (tid & 63) | (tid >> 7 << 6);  // 0 .. 127
      const int ur = ui >> 3, uc = (ui & 7) * kCw;
#pragma unroll
      for (int k = 0; k < kBlocks - 1; ++k) {
        bar_sync(1 + k, kPipe);
        update_rows<1>(diag, x, upd, sub_row(k), sub_row(k + 1) + ur, uc, k);
        bar_arrive(4 + k, kPipe);
        if (k + 2 < kBlocks) {
          // the rows of the sub-blocks after the next, in solve order
          if constexpr (kForward)
            update_rows<kBlocks - 2>(diag, x, upd, sub_row(k),
                                     sub_row(k + 2) + ur, uc, k);
          else
            update_rows<kBlocks - 2>(diag, x, upd, sub_row(k), ur, uc, k);
        }
      }
    }
    __syncthreads();
  }

  // First row of the k-th sub-block in solve order.
  __device__ static constexpr int sub_row(int k) {
    return (kForward ? k : kNb / kSub - 1 - k) * kSub;
  }

  // One thread's column of a sub-block at row o0, its rows' updates so far
  // in upd (none if `fresh`): forward substitution with L's column p
  // (y_p = (z_p - w_p) / L[p][p], then w[o] += L[o][p] y_p, o > p), or
  // backward with row p of L^T (x_p = (z_p - (w_p + sum_{o > p} L[o][p]
  // x_o)) / L[p][p], the sum in four parts).
  __device__ void solve_sub_block(const T* diag, const T* inv, T* x,
                                  const T* upd, int o0, bool fresh) const {
    T z[kSub], w[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      z[i] = x[(o0 + i) * kBp + tid];
      w[i] = fresh ? T(0) : upd[(o0 + i) * kBp + tid];
    }
    if constexpr (kForward) {
#pragma unroll
      for (int p = 0; p < kSub; ++p) {
        const T y = (z[p] - w[p]) * inv[o0 + p];
        z[p] = y;
#pragma unroll
        for (int o4 = 0; o4 < kSub; o4 += 4) {
          if (o4 + 3 > p) {
            T d[4];
            load4(diag + at(o0 + p, o0 + o4), d);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (o4 + e > p) w[o4 + e] = fma(d[e], y, w[o4 + e]);
          }
        }
      }
    } else {
#pragma unroll
      for (int p = kSub - 1; p >= 0; --p) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int o4 = 0; o4 < kSub; o4 += 4) {
          if (o4 + 3 > p) {
            T d[4];
            load4(diag + at(o0 + p, o0 + o4), d);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (o4 + e > p) acc[e] = fma(d[e], z[o4 + e], acc[e]);
          }
        }
        z[p] = (z[p] - (w[p] + ((acc[0] + acc[1]) + (acc[2] + acc[3])))) *
               inv[o0 + p];
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) x[(o0 + i) * kBp + tid] = z[i];
  }

  // The updates of rows row, row + 16, ... of columns uc .. uc + kCw - 1
  // from the solved sub-block at row o0, added to their sums in upd (which
  // the k-th sub-block's updates start): upd[o] += sum_p U[o][p] x_p with
  // U = L forward, L^T backward.  kRows 1: one row; else the rows of the
  // sub-blocks after the k-th's next in solve order, 2 - k of them.
  template <int kRows>
  __device__ void update_rows(const T* diag, const T* x, T* upd, int o0,
                              int row, int uc, int k) const {
    const int rows = kRows == 1 ? 1 : kNb / kSub - 2 - k;
    T z[kRows][kCw];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < rows) {
        if (k == 0) {
#pragma unroll
          for (int q = 0; q < kCw; ++q) z[j][q] = T(0);
        } else {
          load_cols<T>(upd + (row + j * kSub) * kBp + uc, z[j]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kSub; ++p) {
      T y[kCw];
      load_cols<T>(x + (o0 + p) * kBp + uc, y);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (j < rows) {
          const int o = row + j * kSub;
          // forward L[o][o0 + p], backward L[o0 + p][o]
          const T d = kForward ? diag[at(o0 + p, o)] : diag[at(o, o0 + p)];
#pragma unroll
          for (int q = 0; q < kCw; ++q) z[j][q] = fma(d, y[q], z[j][q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < rows) store_cols<T>(upd + (row + j * kSub) * kBp + uc, z[j]);
  }

  __device__ void chain() const {
    constexpr int kSets = L::kSets;
    const int n_rb = a.n_rb, m = a.m;
    T* inv = smem + L::kInv;
    issue_step(0, smem);
    cp_async_commit();
    for (int t = 0; t < n_rb; ++t) {
      T* set = smem + (kSets == 2 ? t & 1 : 0) * L::kSet;
      const int blk = block_of(t);
      const int state = await_partial(t);
      if (state == kClaimed) {
        // the ring is the streaming stages' too: compute P_t, fetch again
        cp_async_wait<0>();
        __syncthreads();
        partial(t);
        issue_step(t, set);
      }
      issue_block(set + 2 * L::kTile, a.part, blk);
      cp_async_commit();
      // the tiles (the partial may land during the product)
      if (state == kClaimed)
        cp_async_wait<0>();
      else
        cp_async_wait<1>();
      __syncthreads();

      const T* tile = set;
      const T* diag = set + L::kTile;
      const T* p_t = set + 2 * L::kTile;
      T* x_prev = smem + L::kX + ((t + 1) & 1) * L::kRhs;
      T* x_cur = smem + L::kX + (t & 1) * L::kRhs;
      // the identity past m
      if (tid < kNb)
        inv[tid] = blk * kNb + tid < m ? T(1) / diag[at(tid, tid)] : T(1);
      T acc[4][kCw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < kCw; ++q) acc[i][q] = T(0);
      if (t > 0) multiply<false>(tile, x_prev, acc, acc);
      cp_async_wait<0>();
      __syncthreads();
      subtract(p_t, x_cur, acc);
      // the next step's tiles into the other set while this one solves
      const bool ahead = kSets == 2 && t + 1 < n_rb;
      substitute(diag, inv, x_cur, ahead ? t + 1 : -1,
                 smem + ((t + 1) & 1) * L::kSet);
      store_block(a.work, blk, x_cur);
      __syncthreads();
      if (tid == 0) st_release(flags() + t, 1);
      if (kSets == 1 && t + 1 < n_rb) {
        issue_step(t + 1, smem);  // the set's tiles are read: free again
        cp_async_commit();
      }
    }
    cp_async_wait<0>();
  }

  // The output S X, row block by row block as their flags are set, drawn
  // from a counter of their own: the chain writes none of it.
  __device__ void write_output() const {
    T* dst = static_cast<T*>(a.dst);
    const T* scale = static_cast<const T*>(a.scale);
    for (;;) {
      __syncthreads();
      if (tid == 0) s_word[0] = atomicAdd(a.ws + 3, 1);
      __syncthreads();
      const int t = s_word[0];
      if (t >= a.n_rb) break;
      if (tid == 0) wait_flag(flags() + t);
      __syncthreads();
      const int blk = block_of(t), row0 = blk * kNb;
      // from L2: written by the chain's SM during the launch
      const T* x = static_cast<const T*>(a.work) +
                   static_cast<long long>(blk) * L::kRhs;
      for (int e = tid; e < kNb * a.b; e += kThreads) {
        const int r = e / a.b, c = e % a.b;
        const int gr = row0 + r;
        if (gr < a.m) {
          dst[gr * a.dst_rs + c] = __ldcg(x + r * kBp + c) * scale[gr];
        }
      }
    }
  }
};

// One block an SM (its shared memory leaves room for no second), so the
// compiler need not hold a thread to 128 registers: the float32 forward
// solve held there (163 without the cap), the pair took 11% longer at
// m = 30,000 on the H100.
template <typename T, bool kForward>
__global__ void __launch_bounds__(kThreads, 1)
    chol_solve_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int s_word[2];
  __shared__ unsigned s_ready[2];
  const Solver<T, kForward> solver(a, reinterpret_cast<T*>(smem4), s_word,
                                       s_ready);
  int* const ticket = a.ws;
  int* const done = a.ws + 1;
  int* const owner = a.ws + 2;
  if (threadIdx.x == 0) s_word[0] = atomicCAS(owner, 0, 1) == 0 ? -1 : 0;
  __syncthreads();
  if (s_word[0] == -1) {
    __syncthreads();
    solver.chain();
  } else {
    for (;;) {
      __syncthreads();
      if (threadIdx.x == 0) s_word[0] = atomicAdd(ticket, 1);
      __syncthreads();
      const int t = s_word[0];
      if (t >= a.n_rb) break;
      solver.partial(t);
    }
  }
  if constexpr (!kForward) solver.write_output();

  // the last block out leaves the counters and the flags zero
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(done, 1) == static_cast<int>(gridDim.x) - 1) {
      for (int i = 0; i < 2 * a.n_rb; ++i) a.ws[4 + i] = 0;
      *ticket = 0;
      *owner = 0;
      a.ws[3] = 0;
      *done = 0;
      __threadfence();
    }
  }
}

template <typename T, bool kForward>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = chol_solve_kernel<T, kForward>;
  const size_t smem = Layout<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // the chain and a block a row block at most
  const int want = a.n_rb + 1;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_of(const Args& a, int forward, cudaStream_t stream) {
  return forward ? launch<T, true>(a, stream) : launch<T, false>(a, stream);
}

}  // namespace

// One triangular solve of the pair: forward (L Y = S B, `forward` 1, Y to
// `work`) or backward (L^T X = Y from `src`, then S X to `dst`).  `l` and
// `ldl` multiples of 16 bytes; `part` and `work` hold n_rb 64 rows of 48
// columns; `ws` 2 n_rb + 4 ints a stream, zero before the first launch
// (each launch leaves them zero).
extern "C" int sc_chol_solve(const void* l, long long ldl, int m,
                             const void* src, long long src_rs,
                             long long src_cs, int b, const void* scale,
                             void* part, void* work, void* dst,
                             long long dst_rs, void* ws, int forward, int f64,
                             void* stream) {
  const int size = f64 ? 8 : 4;
  if (m <= 0 || b <= 0 || b > kMaxColumns || ldl < m || (ldl * size) % 16 ||
      reinterpret_cast<std::uintptr_t>(l) % 16)
    return cudaErrorInvalidValue;
  Args a;
  a.l = l;
  a.ldl = ldl;
  a.m = m;
  a.n_rb = (m + kNb - 1) / kNb;
  a.src = src;
  a.src_rs = src_rs;
  a.src_cs = src_cs;
  a.b = b;
  a.scale = scale;
  a.part = part;
  a.work = work;
  a.dst = dst;
  a.dst_rs = dst_rs;
  a.ws = static_cast<int*>(ws);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f64 ? launch_of<double>(a, forward, s)
                              : launch_of<float>(a, forward, s));
}
