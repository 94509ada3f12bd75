// Brute-force nearest-neighbour search for Hopper (sm_90a), fp32.
//
// Ports of the four Pallas TPU kernels of autourdf_tpu/ops/knn.py:
//
//   nn_bidir_kernel      <- _nn_bidir_kernel     (knn.py:149, launcher
//                           _nn_bidir_pallas, pallas_call knn.py:205)
//   nn_min_bidir_kernel  <- _nn_min_bidir_kernel (knn.py:313, launcher
//                           _nn_min_bidir_pallas, pallas_call knn.py:366)
//   nn_kernel            <- _nn_kernel           (knn.py:54, launcher
//                           _nn_pallas, pallas_call knn.py:104)
//   nn_bidir_acc_kernel  <- _nn_bidir_acc_kernel (knn.py:233, launcher
//                           _nn_bidir_pallas_acc, pallas_call knn.py:289)
//
// All take a batch, x (S, N, 3) and y (S, M, 3), contiguous: one launch
// serves every sequence (or every cluster of a batched ICP), as jax.vmap
// did.  norm 1 is the L1 distance, norm 2 the squared L2 distance.
//
// The two indexed searches (nn_bidir_kernel, nn_bidir_acc_kernel)
// ----------------------------------------------------------------
// Both are one sweep, bidir_sweep, with two ways of bringing the column side
// together.
//
// What bounds them on the H100: the rate of unfused fp32 instructions.
// An L1 distance is 3 subtracts and 2 adds (absolute values are operand
// modifiers) with no multiply-add to fuse, and the build passes -fmad=false
// for bit parity, so the card's fp32 peak, which counts a fused multiply-add
// as two operations, is out of reach by a factor of two before any
// bookkeeping.  The clouds are small (60 KB at 5,000 points, 240 KB at
// 20,000) and every block reads them from L2: the kernel never waits on
// memory, so TMA and multi-stage pipelines have nothing to hide.  Tensor
// cores do not apply: the contraction depth is 3, the main norm is L1, and
// the squared-L2 expansion |x|^2 + |y|^2 - 2 x.y that would use them rounds
// differently from the difference form the reference keeps on purpose.  What
// is left to win is the instruction count per (x, y) pair beyond the
// distance itself, and that is what the design attacks.
//
// Design.
//   - A block owns `rows` x rows (a multiple of kSubRows, chosen per launch),
//     all parked in shared memory (rows past N hold +inf), and a chunk of
//     `cols` y columns.  It takes its rows in register sub-tiles of kSubRows.
//   - Grouped minima with a deferred argmin.  A thread holds kGroupCols
//     consecutive y columns in registers, so one shared-memory load of an x
//     row serves kGroupCols pairs.  For the row side it reduces the row's
//     kGroupCols distances with fminf and updates the running (minimum,
//     group base column) under strictly-less; for the column side it reduces
//     each column's distances over kGroupRows consecutive rows with fminf
//     and updates the running (minimum, row group) under strictly-less.
//     Groups are visited in ascending order, so the group kept is the first
//     that holds the minimum.  The exact index is resolved afterwards by
//     recomputing the few distances of the winning group (the same
//     operations, so bit-identical) and taking the first that equals the
//     minimum: once per row and sub-tile after the block's fold for the row
//     side; for the column side once per column, after the blocks have met,
//     in the fold or the unpack kernel (row groups are disjoint ascending
//     ranges across blocks too, so the lowest group that reaches the minimum
//     holds the first row).  Strictly-less over ascending groups, then
//     first-equal inside the group, is the first-index rule.  Per pair this
//     leaves the 5 distance instructions, 1.5 for the row side, 1.5 for the
//     column side and a quarter of a shared load, where a per-pair (min,
//     argmin) update on both sides took 6 and a full load: 9.1 SASS
//     instructions a pair in the inner loop, counted by chip_smoke.py.  On
//     an NVIDIA H100 80GB HBM3 at 700 W the sweep alone takes 0.052 ms at
//     S=5, N=M=4,988, norm 1 (the first design: 0.077 ms), about two thirds
//     of what its instruction count would allow at one instruction a clock
//     and scheduler: minimum, compare and select instructions cost the card
//     about twice what an add does (PERF.md).
//   - The row side of a sub-tile is folded over the warp with two REDUX
//     instructions per row (the minimum of the distance bits, then the lowest
//     group base among the lanes that hold it), over the warps through
//     shared memory, and resolved by one lane per row.
//   - The column side meets per block, not per register tile.  The running
//     column (minimum, row group) of all the chunk's columns lives in dynamic
//     shared memory between sub-tiles, in slots private to a thread (no
//     synchronisation inside the sweep), and leaves the block once:
//       nn_bidir_kernel writes (S, blocks, M) partials, which
//       fold_partials_kernel folds first-block-first, exactly as
//       knn.py:226-230 folds the TPU kernel's (tiles, M) block: no atomics,
//       a deterministic fold, 8 * M bytes of shared memory (a shape that
//       does not fit is not taken: the dispatch sends it to the accumulator);
//       nn_bidir_acc_kernel has no scratch beyond one 64-bit word per point:
//       distance bits high, index low, merged with atomicMin.  A
//       non-negative fp32 orders as its bits, so the smallest word is the
//       smallest distance and, among equal distances, the smallest index:
//       the first-index rule of the TPU kernel's ordered grid
//       (knn.py:263-268) in any block order.  A block reads the word first
//       and sends the atomic only when it lowers it.  Here the column axis
//       is also cut into chunks across blocks (8 * cols bytes of shared
//       memory whatever M is), so the row side meets through the same kind
//       of word; unpack_words_kernel splits the words into (distance, index)
//       outputs and takes the columns' deferred argmin.
//   - rows, cols and the threads per block come from the caller
//     (ops/knn.py plan_bidir), which picks them from S, N, M and the SM
//     count so that the grid fills the card evenly.
//
// The one-directional and the min-only search (nn_kernel, nn_min_bidir_kernel)
// ---------------------------------------------------------------------------
// Both are a second sweep, light_sweep, which keeps what the indexed sweep
// does on its row side and drops what they do not need.
//
// What bounds them: the same rate of unfused fp32 instructions.  At norm 2
// the distance is 3 subtracts, 3 multiplies and 2 adds, 8 instructions a
// pair, none of them fused (bit parity), so the card's fp32 peak, which
// counts a fused multiply-add as two operations, stays a factor of two away
// before any bookkeeping, and every minimum, compare or select on top costs
// a scheduler more than an add does (PERF.md).  The design cuts those.
//
//   - Three-input minima.  A distance is never NaN, negative or -0.0, so it
//     orders as the signed integer of its bits, and sm_90's three-input
//     integer minimum (VIMNMX3) folds two values into a running minimum in
//     one instruction where FMNMX takes two.  The results are the same bits.
//   - nn_kernel (x -> y only: ICP correspondences, the carry test) is the
//     row side of the indexed sweep alone: a thread holds kGroupCols
//     consecutive y columns in registers, one shared load of an x row serves
//     them all, one VIMNMX3 and one FMNMX reduce the row's 4 distances to the
//     group's minimum, and a compare and two selects update the running
//     (minimum, group base column) under strictly-less, groups ascending: 5
//     instructions a row and group, 1.25 a pair, where the first design
//     spent 3 a pair.  (Folding the running minimum into the chain, two
//     VIMNMX3 and one compare and select, is one instruction less and was
//     slower: 128 registers where this form takes 119 to 122.)  Two REDUX a row
//     fold the warp, the warps meet in shared memory and one lane a row
//     recomputes the winning group to find the first column that equals the
//     minimum.  No column side: no column registers, no column state in
//     shared memory (16 bytes a row and the fold's buffers are all a block
//     keeps), no scratch, and y is never cut across blocks, so every M is
//     taken.  One kernel serves 100 clouds of 5,000 points against 5,000 and
//     25,600 queries against 2,048: rows and threads come per launch from
//     ops/knn.py plan_bidir.
//   - nn_min_bidir_kernel (both directions, minima only) has no index to
//     defer.  Row side: two VIMNMX3 fold a row's 4 distances into its running
//     minimum, one REDUX a row folds the warp.  Column side: the rows go two at a time, so one VIMNMX3
//     folds both into a column's running minimum, which lives in registers
//     during a pass and in private shared slots (4 bytes a column) between
//     the block's sub-tiles; a column leaves the block once: one atomicMin
//     on the fp32 bits a (block, column), sent only when it lowers the word,
//     where the first design sent one a (32-row tile, column).  One minimum
//     instruction a pair in all, where the first design had two and a full
//     shared load.  y is cut into chunks across blocks where its state would
//     not fit, so the row side merges the same way.  The +inf the words start
//     from is written by a fill kernel in the same library call.
//   - The warps' row fold has two buffers, taken in turns, so a sub-tile
//     costs one barrier and the warps do not wait for warp 0's resolve.
//
// Bit-level parity.  The distance keeps the JAX order (knn.py:67-71):
// |x0-y0| + |x1-y1| + |x2-y2| (or d0*d0 + d1*d1 + d2*d2) summed left to
// right, every operation rounded on its own (__fadd_rn/__fmul_rn are never
// contracted into FMAs; the build also passes -fmad=false).  The plain
// PyTorch versions in ops/knn.py do the same elementwise operations, so
// distances are bit-identical and indices match exactly.  Distances are
// never -0.0 (sums of absolute values or of squares), which the 64-bit
// words rely on.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <int NORM>
__device__ __forceinline__ float pair_dist(const float4 a, float b0, float b1, float b2) {
  const float d0 = __fsub_rn(a.x, b0);
  const float d1 = __fsub_rn(a.y, b1);
  const float d2 = __fsub_rn(a.z, b2);
  if (NORM == 1) {
    return __fadd_rn(__fadd_rn(fabsf(d0), fabsf(d1)), fabsf(d2));
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

// ---------------------------------------------------------------------------
// The indexed bidirectional sweep (nn_bidir_kernel, nn_bidir_acc_kernel).
// ---------------------------------------------------------------------------

constexpr int kSubRows = 32;          // x rows per register sub-tile
constexpr int kGroupRows = 4;         // rows per column-side group
constexpr int kGroupCols = 4;         // columns a thread holds: the row-side group
constexpr int kSubGroups = kSubRows / kGroupRows;
constexpr int kSweepMaxThreads = 512; // 128 registers a thread at most
constexpr int kSharedLimit = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ unsigned long long pack_word(unsigned int dist_bits, int idx) {
  return ((unsigned long long)dist_bits << 32) | (unsigned int)idx;
}

// Lower *p to w (a 64-bit (distance bits, index) word or the 32 bits of a
// distance).  The word only ever decreases, so a stale read costs at most a
// needless atomic.
template <typename Word>
__device__ __forceinline__ void merge_word(Word* p, Word w) {
  if (w < *reinterpret_cast<volatile Word*>(p)) atomicMin(p, w);
}

// The deferred argmin of the column side: of the kGroupRows x rows from
// `group_row` on (a multiple of kGroupRows), the first whose distance to the
// y point equals the column's minimum.  The distance is recomputed with the
// sweep's own operations, so it is bit-identical to the one that won.
template <int NORM>
__device__ __forceinline__ int first_row_of_group(const float* __restrict__ xb, int n,
                                                  int group_row, float y0, float y1, float y2,
                                                  float cmin) {
  int first = group_row;
#pragma unroll
  for (int r = kGroupRows - 1; r >= 0; --r) {
    const int row = group_row + r;
    if (row < n) {
      const float4 xv = make_float4(xb[3 * row], xb[3 * row + 1], xb[3 * row + 2], 0.f);
      if (pair_dist<NORM>(xv, y0, y1, y2) == cmin) first = row;
    }
  }
  return first;
}

// A thread's kGroupCols consecutive y columns from j0 on: 12 consecutive
// floats, three 16-byte loads where the batch entry's y happens to be aligned
// (vec_ok: the chunk's first column is; j0 is a multiple of 4 columns = 48
// bytes further).  Columns past the chunk hold -inf: +inf away from every x
// row, the +inf rows included (no NaN), so they never win a row minimum.
__device__ __forceinline__ void load_columns(const float* __restrict__ yb, int j0, int col_end,
                                             bool vec_ok, float (&yc)[kGroupCols][3]) {
  if (vec_ok && j0 + kGroupCols <= col_end) {
    const float4* p = reinterpret_cast<const float4*>(yb + 3 * (size_t)j0);
    const float4 a = p[0], b = p[1], c = p[2];
    yc[0][0] = a.x; yc[0][1] = a.y; yc[0][2] = a.z;
    yc[1][0] = a.w; yc[1][1] = b.x; yc[1][2] = b.y;
    yc[2][0] = b.z; yc[2][1] = b.w; yc[2][2] = c.x;
    yc[3][0] = c.y; yc[3][1] = c.z; yc[3][2] = c.w;
  } else {
#pragma unroll
    for (int c = 0; c < kGroupCols; ++c) {
      const bool in = j0 + c < col_end;
#pragma unroll
      for (int k = 0; k < 3; ++k) yc[c][k] = in ? yb[3 * (size_t)(j0 + c) + k] : -CUDART_INF_F;
    }
  }
}

// Shared memory of a block: the x rows, the cross-warp row fold, and (only
// when the block has more than one sub-tile) the running column state.
__host__ __device__ inline int sweep_state_slots(int rows, int cols, int threads) {
  if (rows <= kSubRows) return 0;
  const int span = threads * kGroupCols;
  return (cols + span - 1) / span * span;
}

__host__ __device__ inline int sweep_shared_bytes(int rows, int cols, int threads) {
  return rows * 16 + (threads / 32) * kSubRows * 8 + sweep_state_slots(rows, cols, threads) * 8;
}

// One block: x rows [blockIdx.x * rows, +rows) against y columns
// [blockIdx.y * cols, +cols) of batch entry blockIdx.z.
//   ACC false: the chunk is all of y (gridDim.y == 1); row results go to
//     (dx, ix), column partials to (cmin, carg), both (S, gridDim.x, M).
//   ACC true: row results merge into rpacked (S, N), column results into
//     cpacked (S, M), 64-bit (distance bits, index) words.
// A column result is the minimum and the first row of the row group that
// holds the first minimum; the fold (or the unpack) finds the row inside it.
template <int NORM, bool ACC>
__device__ __forceinline__ void bidir_sweep(const float* __restrict__ x,
                                            const float* __restrict__ y, int n, int m, int rows,
                                            int cols, float* __restrict__ dx,
                                            int64_t* __restrict__ ix, float* __restrict__ cmin,
                                            int* __restrict__ carg, unsigned long long* rpacked,
                                            unsigned long long* cpacked) {
  extern __shared__ float4 sweep_smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const int s = blockIdx.z;
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * cols;
  const int col_end = min(m, col0 + cols);
  const float* xb = x + (size_t)s * n * 3;
  const float* yb = y + (size_t)s * m * 3;

  float4* xs = sweep_smem;
  unsigned int* red_bits = reinterpret_cast<unsigned int*>(xs + rows);
  int* red_base = reinterpret_cast<int*>(red_bits + nwarps * kSubRows);
  float* st_min = reinterpret_cast<float*>(red_base + nwarps * kSubRows);
  int* st_grp = reinterpret_cast<int*>(st_min + sweep_state_slots(rows, cols, threads));

  for (int i = tid; i < rows; i += threads) {
    const int r = row0 + i;
    xs[i] = r < n ? make_float4(xb[3 * r], xb[3 * r + 1], xb[3 * r + 2], 0.f)
                  : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
  __syncthreads();

  const int span = threads * kGroupCols;
  const int iters = (col_end - col0 + span - 1) / span;
  const int nsub = (min(rows, n - row0) + kSubRows - 1) / kSubRows;
  const bool vec_ok = (reinterpret_cast<uintptr_t>(yb + 3 * (size_t)col0) & 15) == 0;

  for (int sub = 0; sub < nsub; ++sub) {
    const float4* xt = xs + sub * kSubRows;
    float rmin[kSubRows];
    int rbase[kSubRows];
#pragma unroll
    for (int i = 0; i < kSubRows; ++i) {
      rmin[i] = CUDART_INF_F;
      rbase[i] = col0;
    }

    for (int it = 0; it < iters; ++it) {
      const int slot = (it * threads + tid) * kGroupCols;
      const int j0 = col0 + slot;
      float yc[kGroupCols][3];
      load_columns(yb, j0, col_end, vec_ok, yc);

      float cm[kGroupCols];
      int cg[kGroupCols];
      if (sub == 0) {
#pragma unroll
        for (int c = 0; c < kGroupCols; ++c) {
          cm[c] = CUDART_INF_F;
          cg[c] = 0;
        }
      } else {
        const float4 v = *reinterpret_cast<const float4*>(st_min + slot);
        const int4 g = *reinterpret_cast<const int4*>(st_grp + slot);
        cm[0] = v.x; cm[1] = v.y; cm[2] = v.z; cm[3] = v.w;
        cg[0] = g.x; cg[1] = g.y; cg[2] = g.z; cg[3] = g.w;
      }

#pragma unroll
      for (int g = 0; g < kSubGroups; ++g) {
        float d[kGroupRows][kGroupCols];
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          const int i = g * kGroupRows + r;
          const float4 xv = xt[i];
#pragma unroll
          for (int c = 0; c < kGroupCols; ++c) {
            d[r][c] = pair_dist<NORM>(xv, yc[c][0], yc[c][1], yc[c][2]);
          }
          const float low = fminf(fminf(d[r][0], d[r][1]), fminf(d[r][2], d[r][3]));
          if (low < rmin[i]) {
            rmin[i] = low;
            rbase[i] = j0;
          }
        }
        const int grp = sub * kSubGroups + g;
#pragma unroll
        for (int c = 0; c < kGroupCols; ++c) {
          float low = d[0][c];
#pragma unroll
          for (int r = 1; r < kGroupRows; ++r) low = fminf(low, d[r][c]);
          if (low < cm[c]) {
            cm[c] = low;
            cg[c] = grp;
          }
        }
      }

      if (sub + 1 < nsub) {
        *reinterpret_cast<float4*>(st_min + slot) = make_float4(cm[0], cm[1], cm[2], cm[3]);
        *reinterpret_cast<int4*>(st_grp + slot) = make_int4(cg[0], cg[1], cg[2], cg[3]);
      } else {
        // the block's last sub-tile: its column results leave the block
#pragma unroll
        for (int c = 0; c < kGroupCols; ++c) {
          const int j = j0 + c;
          if (j >= col_end) continue;
          const int group_row = row0 + cg[c] * kGroupRows;
          if (ACC) {
            merge_word(cpacked + (size_t)s * m + j, pack_word(__float_as_uint(cm[c]), group_row));
          } else {
            const size_t at = ((size_t)s * gridDim.x + blockIdx.x) * m + j;
            cmin[at] = cm[c];
            carg[at] = group_row;
          }
        }
      }
    }

    // Row side of the sub-tile.  Over the warp: the minimum of the distance
    // bits, then the lowest group base among the lanes that hold it; lane i
    // keeps row i's pair.  Groups are disjoint ascending column ranges, so
    // the lowest base that reaches the minimum holds the first index.
    unsigned int my_bits = 0;
    int my_base = 0;
#pragma unroll
    for (int i = 0; i < kSubRows; ++i) {
      const unsigned int bits = __float_as_uint(rmin[i]);
      const unsigned int wbits = __reduce_min_sync(0xffffffffu, bits);
      const int wbase = __reduce_min_sync(0xffffffffu, bits == wbits ? rbase[i] : 0x7fffffff);
      if (lane == i) {
        my_bits = wbits;
        my_base = wbase;
      }
    }
    red_bits[warp * kSubRows + lane] = my_bits;
    red_base[warp * kSubRows + lane] = my_base;
    __syncthreads();
    if (warp == 0) {
      unsigned int bits = red_bits[lane];
      int base = red_base[lane];
      for (int w = 1; w < nwarps; ++w) {
        const unsigned int ob = red_bits[w * kSubRows + lane];
        const int obase = red_base[w * kSubRows + lane];
        if (ob < bits || (ob == bits && obase < base)) {
          bits = ob;
          base = obase;
        }
      }
      // the deferred argmin of the row side: first column of the winning
      // group whose distance equals the minimum
      const float4 xv = xt[lane];
      int idx = base;
#pragma unroll
      for (int c = kGroupCols - 1; c >= 0; --c) {
        const int j = base + c;
        if (j < col_end) {
          const float d = pair_dist<NORM>(xv, yb[3 * (size_t)j], yb[3 * (size_t)j + 1],
                                          yb[3 * (size_t)j + 2]);
          if (__float_as_uint(d) == bits) idx = j;
        }
      }
      const int r = row0 + sub * kSubRows + lane;
      if (r < n) {
        if (ACC) {
          merge_word(rpacked + (size_t)s * n + r, pack_word(bits, idx));
        } else {
          dx[(size_t)s * n + r] = __uint_as_float(bits);
          ix[(size_t)s * n + r] = idx;
        }
      }
    }
    __syncthreads();   // the fold's buffers are free for the next sub-tile
  }
}

template <int NORM>
__global__ void __launch_bounds__(kSweepMaxThreads)
nn_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int rows,
                float* __restrict__ dx, int64_t* __restrict__ ix, float* __restrict__ cmin,
                int* __restrict__ carg) {
  bidir_sweep<NORM, false>(x, y, n, m, rows, m, dx, ix, cmin, carg, nullptr, nullptr);
}

template <int NORM>
__global__ void __launch_bounds__(kSweepMaxThreads)
nn_bidir_acc_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                    int rows, int cols, unsigned long long* rpacked,
                    unsigned long long* cpacked) {
  bidir_sweep<NORM, true>(x, y, n, m, rows, cols, nullptr, nullptr, nullptr, nullptr, rpacked,
                          cpacked);
}

// Fold of the per-block column partials (S, blocks, M) over blocks, the
// first block winning a tie (blocks ascend in x rows, so its row group is
// the first that holds the minimum), then the deferred argmin inside that
// group.  A block of (64, 4) threads takes 64 columns; each of the 4 slices
// walks a quarter of the blocks in ascending order, slice 0 merges.
constexpr int kFoldCols = 64;
constexpr int kFoldSlices = 4;

template <int NORM>
__global__ void __launch_bounds__(kFoldCols * kFoldSlices)
fold_partials_kernel(const float* __restrict__ cmin, const int* __restrict__ carg, int blocks,
                     const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                     float* __restrict__ dy, int64_t* __restrict__ iy) {
  __shared__ float sd[kFoldSlices][kFoldCols];
  __shared__ int sb[kFoldSlices][kFoldCols];
  const int j = blockIdx.x * kFoldCols + threadIdx.x;
  const int s = blockIdx.y;
  const int per = (blocks + kFoldSlices - 1) / kFoldSlices;
  const int b0 = threadIdx.y * per;
  const int b1 = min(blocks, b0 + per);
  const float* col = cmin + (size_t)s * blocks * m + j;
  float d = CUDART_INF_F;
  int best = -1;
  if (j < m) {
    for (int b = b0; b < b1; ++b) {
      const float v = col[(size_t)b * m];
      if (v < d) {
        d = v;
        best = b;
      }
    }
  }
  sd[threadIdx.y][threadIdx.x] = d;
  sb[threadIdx.y][threadIdx.x] = best;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
#pragma unroll
    for (int k = 1; k < kFoldSlices; ++k) {
      if (sd[k][threadIdx.x] < d) {
        d = sd[k][threadIdx.x];
        best = sb[k][threadIdx.x];
      }
    }
    if (best < 0) best = 0;   // every partial +inf: the first block's group
    const float* yp = y + ((size_t)s * m + j) * 3;
    const int group_row = carg[((size_t)s * blocks + best) * m + j];
    dy[(size_t)s * m + j] = d;
    iy[(size_t)s * m + j] =
        first_row_of_group<NORM>(x + (size_t)s * n * 3, n, group_row, yp[0], yp[1], yp[2], d);
  }
}

template <typename Word>
__global__ void fill_words_kernel(Word* words, long long count, Word value) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count) words[k] = value;
}

// words [0, S * N) -> (dx, ix): (distance bits, y index), complete.
// words [S * N, S * (N + M)) -> (dy, iy): (distance bits, first row of the
// row group that holds the first minimum); the deferred argmin inside the
// group is taken here.
template <int NORM>
__global__ void unpack_words_kernel(const unsigned long long* __restrict__ words,
                                    const float* __restrict__ x, const float* __restrict__ y,
                                    int s_count, int n, int m, float* __restrict__ dx,
                                    int64_t* __restrict__ ix, float* __restrict__ dy,
                                    int64_t* __restrict__ iy) {
  const long long row_count = (long long)s_count * n;
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= row_count + (long long)s_count * m) return;
  const unsigned long long w = words[k];
  const float d = __uint_as_float((unsigned int)(w >> 32));
  const int low = (int)(w & 0xffffffffull);
  if (k < row_count) {
    dx[k] = d;
    ix[k] = low;
  } else {
    const long long c = k - row_count;
    const int s = (int)(c / m);
    const float* yp = y + c * 3;
    dy[c] = d;
    iy[c] = first_row_of_group<NORM>(x + (size_t)s * n * 3, n, low, yp[0], yp[1], yp[2], d);
  }
}

// ---------------------------------------------------------------------------
// The one-sided and the index-free sweep (nn_kernel, nn_min_bidir_kernel).
// ---------------------------------------------------------------------------

constexpr unsigned int kInfBits = 0x7f800000u;

// The minimum of three distances.  They are never NaN, never negative and
// never -0.0, so they order as the signed integers of their bits, and one
// three-input integer minimum (VIMNMX3, a DPX instruction of sm_90) does
// what two FMNMX would, on the same bits (the min-only sweep took 14% less
// time with it than with FMNMX; PERF.md).  The order of the folds does not
// show in the result.
__device__ __forceinline__ float min3(float a, float b, float c) {
  return __int_as_float(__vimin3_s32(__float_as_int(a), __float_as_int(b), __float_as_int(c)));
}

// min(acc, v[0], ..., v[COUNT - 1])
template <int COUNT>
__device__ __forceinline__ float min_into(float acc, const float* v) {
  int k = 0;
#pragma unroll
  for (; k + 1 < COUNT; k += 2) acc = min3(acc, v[k], v[k + 1]);
  if (k < COUNT) acc = fminf(acc, v[k]);
  return acc;
}

// Shared memory of a block: the x rows, two buffers of the cross-warp row
// fold (the bits, and the group bases of the indexed sweep) and, in the
// min-only sweep of more than one sub-tile, 4 bytes of running column
// minimum per slot.
__host__ __device__ inline int light_state_slots(bool indexed, int rows, int cols, int threads) {
  if (indexed || rows <= kSubRows) return 0;
  const int span = threads * kGroupCols;
  return (cols + span - 1) / span * span;
}

__host__ __device__ inline int light_shared_bytes(bool indexed, int rows, int cols, int threads) {
  return rows * 16 + 2 * (threads / 32) * kSubRows * (indexed ? 8 : 4) +
         light_state_slots(indexed, rows, cols, threads) * 4;
}

// One block: x rows [blockIdx.x * rows, +rows) against y columns
// [blockIdx.y * cols, +cols) of batch entry blockIdx.z; a thread holds
// kGroupCols consecutive columns.
//   INDEXED: x -> y only, minimum and first index, written to (dx, ix); the
//     chunk is all of y (gridDim.y == 1).
//   not INDEXED: minima of both directions, merged into row_bits (S, N) and
//     col_bits (S, M), the bits of fp32 distances, which start at +inf.
template <int NORM, bool INDEXED>
__device__ __forceinline__ void light_sweep(const float* __restrict__ x,
                                            const float* __restrict__ y, int n, int m, int rows,
                                            int cols, float* __restrict__ dx,
                                            int64_t* __restrict__ ix, unsigned int* row_bits,
                                            unsigned int* col_bits) {
  extern __shared__ float4 sweep_smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const int s = blockIdx.z;
  const int row0 = blockIdx.x * rows;
  const int col0 = blockIdx.y * cols;
  const int col_end = min(m, col0 + cols);
  const float* xb = x + (size_t)s * n * 3;
  const float* yb = y + (size_t)s * m * 3;

  float4* xs = sweep_smem;
  const int fold_slots = nwarps * kSubRows;
  unsigned int* fold_bits = reinterpret_cast<unsigned int*>(xs + rows);          // two buffers
  int* fold_base = reinterpret_cast<int*>(fold_bits + 2 * fold_slots);           // INDEXED
  float* st_min = reinterpret_cast<float*>(fold_bits + 2 * fold_slots);          // not INDEXED

  for (int i = tid; i < rows; i += threads) {
    const int r = row0 + i;
    xs[i] = r < n ? make_float4(xb[3 * r], xb[3 * r + 1], xb[3 * r + 2], 0.f)
                  : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
  __syncthreads();

  const int span = threads * kGroupCols;
  const int iters = (col_end - col0 + span - 1) / span;
  const int nsub = (min(rows, n - row0) + kSubRows - 1) / kSubRows;
  const bool vec_ok = (reinterpret_cast<uintptr_t>(yb + 3 * (size_t)col0) & 15) == 0;

#pragma unroll 1
  for (int sub = 0; sub < nsub; ++sub) {
    const float4* xt = xs + sub * kSubRows;
    float rmin[kSubRows];
    int rbase[kSubRows];
#pragma unroll
    for (int i = 0; i < kSubRows; ++i) {
      rmin[i] = CUDART_INF_F;
      rbase[i] = col0;
    }

#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      const int slot = (it * threads + tid) * kGroupCols;
      const int j0 = col0 + slot;
      float yc[kGroupCols][3];
      load_columns(yb, j0, col_end, vec_ok, yc);

      float cm[kGroupCols];
      if (!INDEXED) {
        const float4 v = sub == 0 ? make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                                CUDART_INF_F)
                                  : *reinterpret_cast<const float4*>(st_min + slot);
        cm[0] = v.x; cm[1] = v.y; cm[2] = v.z; cm[3] = v.w;
      }

      // two rows a step: a column's running minimum takes both in one min3
#pragma unroll
      for (int i = 0; i < kSubRows; i += 2) {
        float d[2][kGroupCols];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 xv = xt[i + r];
#pragma unroll
          for (int c = 0; c < kGroupCols; ++c) {
            d[r][c] = pair_dist<NORM>(xv, yc[c][0], yc[c][1], yc[c][2]);
          }
          if (INDEXED) {
            // groups ascend with the passes: strictly-less keeps the first
            const float low = min_into<kGroupCols - 1>(d[r][0], d[r] + 1);
            if (low < rmin[i + r]) {
              rmin[i + r] = low;
              rbase[i + r] = j0;
            }
          } else {
            rmin[i + r] = min_into<kGroupCols>(rmin[i + r], d[r]);
          }
        }
        if (!INDEXED) {
#pragma unroll
          for (int c = 0; c < kGroupCols; ++c) cm[c] = min3(cm[c], d[0][c], d[1][c]);
        }
      }

      if (!INDEXED) {
        if (sub + 1 < nsub) {
          *reinterpret_cast<float4*>(st_min + slot) = make_float4(cm[0], cm[1], cm[2], cm[3]);
        } else {
          // the block's last sub-tile: its column minima leave the block
#pragma unroll
          for (int c = 0; c < kGroupCols; ++c) {
            if (j0 + c < col_end) {
              merge_word(col_bits + (size_t)s * m + j0 + c, __float_as_uint(cm[c]));
            }
          }
        }
      }
    }

    // Row side of the sub-tile, as in bidir_sweep: over the warp the minimum
    // of the distance bits and (INDEXED) the lowest group base among the
    // lanes that hold it; lane i keeps row i's.  The warps meet in one of
    // two buffers, taken in turns, so a sub-tile costs one barrier: warp 0
    // reads buffer k while the others fill buffer k + 1, and buffer k is
    // written again only behind the next barrier, which warp 0 joins after
    // its reads.
    unsigned int* red_bits = fold_bits + (sub & 1) * fold_slots;
    int* red_base = fold_base + (sub & 1) * fold_slots;
    unsigned int my_bits = 0;
    int my_base = 0;
#pragma unroll
    for (int i = 0; i < kSubRows; ++i) {
      const unsigned int bits = __float_as_uint(rmin[i]);
      const unsigned int wbits = __reduce_min_sync(0xffffffffu, bits);
      int wbase = 0;
      if (INDEXED) {
        wbase = __reduce_min_sync(0xffffffffu, bits == wbits ? rbase[i] : 0x7fffffff);
      }
      if (lane == i) {
        my_bits = wbits;
        my_base = wbase;
      }
    }
    red_bits[warp * kSubRows + lane] = my_bits;
    if (INDEXED) red_base[warp * kSubRows + lane] = my_base;
    __syncthreads();
    if (warp == 0) {
      unsigned int bits = red_bits[lane];
      int base = INDEXED ? red_base[lane] : 0;
      for (int w = 1; w < nwarps; ++w) {
        const unsigned int ob = red_bits[w * kSubRows + lane];
        if (INDEXED) {
          const int obase = red_base[w * kSubRows + lane];
          if (ob < bits || (ob == bits && obase < base)) {
            bits = ob;
            base = obase;
          }
        } else {
          bits = min(bits, ob);
        }
      }
      const int r = row0 + sub * kSubRows + lane;
      if (INDEXED) {
        // the deferred argmin: first column of the winning group whose
        // distance equals the minimum
        const float4 xv = xt[lane];
        int idx = base;
#pragma unroll
        for (int c = kGroupCols - 1; c >= 0; --c) {
          const int j = base + c;
          if (j < col_end) {
            const float d = pair_dist<NORM>(xv, yb[3 * (size_t)j], yb[3 * (size_t)j + 1],
                                            yb[3 * (size_t)j + 2]);
            if (__float_as_uint(d) == bits) idx = j;
          }
        }
        if (r < n) {
          dx[(size_t)s * n + r] = __uint_as_float(bits);
          ix[(size_t)s * n + r] = idx;
        }
      } else if (r < n) {
        merge_word(row_bits + (size_t)s * n + r, bits);
      }
    }
  }
}

template <int NORM>
__global__ void __launch_bounds__(kSweepMaxThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m, int rows,
          float* __restrict__ dx, int64_t* __restrict__ ix) {
  light_sweep<NORM, true>(x, y, n, m, rows, m, dx, ix, nullptr, nullptr);
}

template <int NORM>
__global__ void __launch_bounds__(kSweepMaxThreads)
nn_min_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                    int rows, int cols, unsigned int* row_bits, unsigned int* col_bits) {
  light_sweep<NORM, false>(x, y, n, m, rows, cols, nullptr, nullptr, row_bits, col_bits);
}

// A launch of bidir_sweep is valid for these block parameters.
inline bool sweep_params_ok(int rows, int cols, int threads) {
  return rows > 0 && rows % kSubRows == 0 && cols > 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= kSweepMaxThreads && sweep_shared_bytes(rows, cols, threads) <= kSharedLimit;
}

// ... and a launch of light_sweep for these.
inline bool light_params_ok(bool indexed, int rows, int cols, int threads) {
  return rows > 0 && rows % kSubRows == 0 && cols > 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= kSweepMaxThreads &&
         light_shared_bytes(indexed, rows, cols, threads) <= kSharedLimit;
}

template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
}

template <int NORM>
cudaError_t launch_nn(const float* x, const float* y, int s, int n, int m, int rows, int threads,
                      float* dx, int64_t* ix, cudaStream_t st) {
  const int shared = light_shared_bytes(true, rows, m, threads);
  const cudaError_t err = allow_shared(nn_kernel<NORM>, shared);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows - 1) / rows, 1, s);
  nn_kernel<NORM><<<grid, threads, shared, st>>>(x, y, n, m, rows, dx, ix);
  return cudaGetLastError();
}

template <int NORM>
cudaError_t launch_min_bidir(const float* x, const float* y, int s, int n, int m, int rows,
                             int cols, int threads, unsigned int* row_bits,
                             unsigned int* col_bits, cudaStream_t st) {
  const int shared = light_shared_bytes(false, rows, cols, threads);
  const cudaError_t err = allow_shared(nn_min_bidir_kernel<NORM>, shared);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows - 1) / rows, (m + cols - 1) / cols, s);
  nn_min_bidir_kernel<NORM><<<grid, threads, shared, st>>>(x, y, n, m, rows, cols, row_bits,
                                                           col_bits);
  return cudaGetLastError();
}
}  // namespace

// ---------------------------------------------------------------------------
// C interface for ctypes.  Each launcher enqueues on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" int knn_sweep_shared_bytes(int rows, int cols, int threads) {
  return sweep_shared_bytes(rows, cols, threads);
}

extern "C" int knn_light_shared_bytes(int indexed, int rows, int cols, int threads) {
  return light_shared_bytes(indexed != 0, rows, cols, threads);
}

// The sweeps' block constants, which ops/knn.py mirrors for its planning:
// 0 kSubRows, 1 kGroupRows, 2 kGroupCols, 3 kSweepMaxThreads, 4 kSharedLimit;
// -1 for any other number.
extern "C" int knn_sweep_constant(int which) {
  constexpr int values[] = {kSubRows, kGroupRows, kGroupCols, kSweepMaxThreads, kSharedLimit};
  return which >= 0 && which < 5 ? values[which] : -1;
}

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64, dy (S, M) f32,
// iy (S, M) i64.  A block owns `rows` x rows (a multiple of 32) and runs
// `threads` threads; scratch holds 2 * S * blocks * M 32-bit words, blocks =
// ceil(N / rows): the per-block column minima, then the first rows of the
// row groups that hold them.  Two launches: the sweep, then the fold.
extern "C" int knn_bidir_launch(const float* x, const float* y, int s, int n, int m, int norm,
                                int rows, int threads, float* dx, int64_t* ix, float* dy,
                                int64_t* iy, void* scratch, void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535 || !sweep_params_ok(rows, m, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + rows - 1) / rows;
  const int shared = sweep_shared_bytes(rows, m, threads);
  float* cmin = static_cast<float*>(scratch);
  int* carg = static_cast<int*>(scratch) + (size_t)s * blocks * m;
  const dim3 grid(blocks, 1, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (norm == 1) {
    if ((err = allow_shared(nn_bidir_kernel<1>, shared)) != cudaSuccess) return (int)err;
    nn_bidir_kernel<1><<<grid, threads, shared, st>>>(x, y, n, m, rows, dx, ix, cmin, carg);
  } else if (norm == 2) {
    if ((err = allow_shared(nn_bidir_kernel<2>, shared)) != cudaSuccess) return (int)err;
    nn_bidir_kernel<2><<<grid, threads, shared, st>>>(x, y, n, m, rows, dx, ix, cmin, carg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 fold_grid((m + kFoldCols - 1) / kFoldCols, s);
  const dim3 fold_block(kFoldCols, kFoldSlices);
  if (norm == 1) {
    fold_partials_kernel<1><<<fold_grid, fold_block, 0, st>>>(cmin, carg, blocks, x, y, n, m, dy,
                                                              iy);
  } else {
    fold_partials_kernel<2><<<fold_grid, fold_block, 0, st>>>(cmin, carg, blocks, x, y, n, m, dy,
                                                              iy);
  }
  return (int)cudaGetLastError();
}

// x (S, N, 3), y (S, M, 3) -> bits: S * (N + M) fp32 values, the x -> y
// minima (S, N) and then the y -> x minima (S, M).  A block owns `rows` x rows
// (a multiple of 32) and `cols` y columns and runs `threads` threads.  Two
// launches: the fill with +inf, the sweep.
extern "C" int knn_min_bidir_launch(const float* x, const float* y, int s, int n, int m,
                                    int norm, int rows, int cols, int threads,
                                    unsigned int* bits, void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535 || !light_params_ok(false, rows, cols, threads) ||
      (m + cols - 1) / cols > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long row_count = (long long)s * n;
  const long long count = row_count + (long long)s * m;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fill_words_kernel<<<(int)((count + 255) / 256), 256, 0, st>>>(bits, count, kInfBits);
  if (norm == 1) {
    return (int)launch_min_bidir<1>(x, y, s, n, m, rows, cols, threads, bits, bits + row_count,
                                    st);
  }
  if (norm == 2) {
    return (int)launch_min_bidir<2>(x, y, s, n, m, rows, cols, threads, bits, bits + row_count,
                                    st);
  }
  return (int)cudaErrorInvalidValue;
}

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64: x -> y only.  A
// block owns `rows` x rows (a multiple of 32) against all of y and runs
// `threads` threads.  One launch.
extern "C" int knn_nn_launch(const float* x, const float* y, int s, int n, int m, int norm,
                             int rows, int threads, float* dx, int64_t* ix, void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535 || !light_params_ok(true, rows, m, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm == 1) return (int)launch_nn<1>(x, y, s, n, m, rows, threads, dx, ix, st);
  if (norm == 2) return (int)launch_nn<2>(x, y, s, n, m, rows, threads, dx, ix, st);
  return (int)cudaErrorInvalidValue;
}

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64, dy (S, M) f32,
// iy (S, M) i64.  A block owns `rows` x rows (a multiple of 32) and `cols` y
// columns and runs `threads` threads; words holds S * (N + M) 64-bit words,
// which are set to init (above every (distance bits) << 32 | index word)
// before the sweep.  Three launches: the fill, the sweep, the unpack.
extern "C" int knn_bidir_acc_launch(const float* x, const float* y, int s, int n, int m,
                                    int norm, int rows, int cols, int threads, float* dx,
                                    int64_t* ix, float* dy, int64_t* iy,
                                    unsigned long long* words, unsigned long long init,
                                    void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535 || !sweep_params_ok(rows, cols, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (m + cols - 1) / cols;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const int shared = sweep_shared_bytes(rows, cols, threads);
  const long long row_count = (long long)s * n;
  const long long count = row_count + (long long)s * m;
  const int word_blocks = (int)((count + 255) / 256);
  unsigned long long* rpacked = words;
  unsigned long long* cpacked = words + row_count;
  const dim3 grid((n + rows - 1) / rows, chunks, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  fill_words_kernel<<<word_blocks, 256, 0, st>>>(words, count, init);
  if (norm == 1) {
    if ((err = allow_shared(nn_bidir_acc_kernel<1>, shared)) != cudaSuccess) return (int)err;
    nn_bidir_acc_kernel<1><<<grid, threads, shared, st>>>(x, y, n, m, rows, cols, rpacked,
                                                          cpacked);
  } else if (norm == 2) {
    if ((err = allow_shared(nn_bidir_acc_kernel<2>, shared)) != cudaSuccess) return (int)err;
    nn_bidir_acc_kernel<2><<<grid, threads, shared, st>>>(x, y, n, m, rows, cols, rpacked,
                                                          cpacked);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (norm == 1) {
    unpack_words_kernel<1><<<word_blocks, 256, 0, st>>>(words, x, y, s, n, m, dx, ix, dy, iy);
  } else {
    unpack_words_kernel<2><<<word_blocks, 256, 0, st>>>(words, x, y, s, n, m, dx, ix, dy, iy);
  }
  return (int)cudaGetLastError();
}
