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
// The other two kernels
// ---------------------
// nn_kernel and nn_min_bidir_kernel keep their first design: a block owns
// kTileRows x rows in shared memory, its kThreads threads sweep all of y,
// thread t taking columns t, t + kThreads, ... in ascending order with a
// per-pair update of a (min, argmin) register pair per tile row, folded by
// warp shuffles and shared memory over (d, idx) pairs, lower index on ties.
// nn_kernel is the one-directional search (ICP correspondences, the carry
// test): row side only, no scratch; it serves both a batch of 100 clouds of
// 5,000 points and one query set of 25,600 points against 2,048.  The
// min-only kernel needs no indices: min is order-free, so its cross-block
// column minimum is an atomicMin on the int bits of the non-negative fp32
// distance.  Both are bound by the same unfused fp32 rate, about 8 to
// 9 operations per pair.
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

// x rows per block.  Each thread keeps a (min, argmin) register pair per
// tile row: at 64 rows the indexed kernel spills (254 registers plus a
// 568-byte stack, ptxas -v on sm_90a), at 32 it fits with no spill.
constexpr int kTileRows = 32;
constexpr int kThreads = 128;   // threads per block
constexpr int kWarps = kThreads / 32;

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

// Lexicographic (distance, index) minimum: the lower index wins a tie.
__device__ __forceinline__ void take_first_min(float& d, int& k, float od, int ok) {
  if (od < d || (od == d && ok < k)) {
    d = od;
    k = ok;
  }
}

__device__ __forceinline__ void load_tile(const float* __restrict__ xb, int n, int row0,
                                          float4* xs) {
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    const int r = row0 + i;
    xs[i] = r < n ? make_float4(xb[3 * r], xb[3 * r + 1], xb[3 * r + 2], 0.f)
                  : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  }
}

// Row results of a block: fold the per-thread (min, argmin) partials of each
// tile row over the warp (shuffles) and then over the warps (shared memory),
// lower column on ties, and write rows below n.
__device__ __forceinline__ void store_row_results(const float (&rmin)[kTileRows],
                                                  const int (&ridx)[kTileRows], int row0, int n,
                                                  float* __restrict__ dx_b,
                                                  int64_t* __restrict__ ix_b,
                                                  float (*red_d)[kTileRows],
                                                  int (*red_i)[kTileRows]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    float d = rmin[i];
    int k = ridx[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(0xffffffffu, d, off);
      const int ok = __shfl_down_sync(0xffffffffu, k, off);
      take_first_min(d, k, od, ok);
    }
    if (lane == 0) {
      red_d[warp][i] = d;
      red_i[warp][i] = k;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    float d = red_d[0][i];
    int k = red_i[0][i];
    for (int w = 1; w < kWarps; ++w) take_first_min(d, k, red_d[w][i], red_i[w][i]);
    const int r = row0 + i;
    if (r < n) {
      dx_b[r] = d;
      ix_b[r] = k;
    }
  }
}

template <int NORM>
__global__ void __launch_bounds__(kThreads)
nn_min_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                    float* __restrict__ dx, unsigned int* __restrict__ cmin_bits) {
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const float* yb = y + (size_t)s * m * 3;
  unsigned int* cbits = cmin_bits + (size_t)s * m;

  __shared__ float4 xs[kTileRows];
  __shared__ float red_d[kWarps][kTileRows];
  load_tile(x + (size_t)s * n * 3, n, row0, xs);
  __syncthreads();

  float rmin[kTileRows];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) rmin[i] = CUDART_INF_F;

  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float y0 = yb[3 * j], y1 = yb[3 * j + 1], y2 = yb[3 * j + 2];
    float cd = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float d = pair_dist<NORM>(xs[i], y0, y1, y2);
      rmin[i] = fminf(rmin[i], d);
      cd = fminf(cd, d);
    }
    // non-negative fp32 orders like its unsigned bit pattern
    atomicMin(cbits + j, __float_as_uint(cd));
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    float d = rmin[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d = fminf(d, __shfl_down_sync(0xffffffffu, d, off));
    if (lane == 0) red_d[warp][i] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
    float d = red_d[0][i];
    for (int w = 1; w < kWarps; ++w) d = fminf(d, red_d[w][i]);
    const int r = row0 + i;
    if (r < n) dx[(size_t)s * n + r] = d;
  }
}

template <int NORM>
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
          float* __restrict__ dx, int64_t* __restrict__ ix) {
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const float* yb = y + (size_t)s * m * 3;

  __shared__ float4 xs[kTileRows];
  __shared__ float red_d[kWarps][kTileRows];
  __shared__ int red_i[kWarps][kTileRows];
  load_tile(x + (size_t)s * n * 3, n, row0, xs);
  __syncthreads();

  float rmin[kTileRows];
  int ridx[kTileRows];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    rmin[i] = CUDART_INF_F;
    ridx[i] = 0;
  }

  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float y0 = yb[3 * j], y1 = yb[3 * j + 1], y2 = yb[3 * j + 2];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float d = pair_dist<NORM>(xs[i], y0, y1, y2);
      if (d < rmin[i]) {
        rmin[i] = d;
        ridx[i] = j;
      }
    }
  }
  store_row_results(rmin, ridx, row0, n, dx + (size_t)s * n, ix + (size_t)s * n, red_d, red_i);
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

// Lower *p to w.  The word only ever decreases, so a stale read costs at
// most a needless atomic.
__device__ __forceinline__ void merge_word(unsigned long long* p, unsigned long long w) {
  if (w < *reinterpret_cast<volatile unsigned long long*>(p)) atomicMin(p, w);
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
  // a thread's kGroupCols columns are 12 consecutive floats: three 16-byte
  // loads where the batch entry's y happens to be aligned
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
      // columns past the chunk hold -inf: +inf away from every x row, the
      // +inf rows included (no NaN), so they never win a row minimum
      float yc[kGroupCols][3];
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

__global__ void fill_words_kernel(unsigned long long* words, long long count,
                                  unsigned long long value) {
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

// A launch of bidir_sweep is valid for these block parameters.
inline bool sweep_params_ok(int rows, int cols, int threads) {
  return rows > 0 && rows % kSubRows == 0 && cols > 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= kSweepMaxThreads && sweep_shared_bytes(rows, cols, threads) <= kSharedLimit;
}

template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedLimit);
}
}  // namespace

// ---------------------------------------------------------------------------
// C interface for ctypes.  Each launcher enqueues on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" int knn_sweep_shared_bytes(int rows, int cols, int threads) {
  return sweep_shared_bytes(rows, cols, threads);
}

// The sweep's block constants, which ops/knn.py mirrors for its planning:
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

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32; cmin_bits (S, M) u32 must hold
// the bits of +inf (0x7f800000) on entry and holds the fp32 column minima
// on exit.
extern "C" int knn_min_bidir_launch(const float* x, const float* y, int s, int n, int m,
                                    int norm, float* dx, unsigned int* cmin_bits,
                                    void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileRows - 1) / kTileRows, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm == 1) {
    nn_min_bidir_kernel<1><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, cmin_bits);
  } else if (norm == 2) {
    nn_min_bidir_kernel<2><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, cmin_bits);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64: x -> y only.
extern "C" int knn_nn_launch(const float* x, const float* y, int s, int n, int m, int norm,
                             float* dx, int64_t* ix, void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileRows - 1) / kTileRows, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm == 1) {
    nn_kernel<1><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix);
  } else if (norm == 2) {
    nn_kernel<2><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
