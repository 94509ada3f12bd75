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
// All take a batch, x (S, N, 3) and y (S, M, 3), contiguous, with a grid
// over (x-tiles, S): one launch serves every sequence (or every cluster of
// a batched ICP), as jax.vmap did.  norm 1 is the L1 distance, norm 2 the
// squared L2 distance.
//
// Design.  A block owns kTileRows x rows, parked in shared memory (rows past
// N are filled with +inf, so they never win a column minimum; their row
// results are not written).  Its kThreads threads sweep all of y, thread t
// taking columns t, t + kThreads, ... in ascending order.  For each column
// a thread walks the tile's rows in ascending order, so:
//   - the column (min, argmin) over the tile comes out of a strictly-less
//     update in registers, first row on ties, with no cross-thread step;
//   - each thread keeps a running (min, argmin) for every tile row in
//     registers (kTileRows of each), strictly-less over its ascending
//     columns; at the end one warp-shuffle plus shared-memory fold over
//     (d, idx) pairs, lower index on ties, gives the exact first-index
//     row argmin whatever order the threads ran in.
// The indexed kernel writes per-tile column partials to an (S, tiles, M)
// scratch, folded outside the kernel over tiles (first tile on ties) exactly
// as knn.py:226-230 folds the TPU kernel's (tiles, M) block.  The min-only
// kernel needs no partials: min is order-free, so the cross-block column
// minimum is an atomicMin on the int bits of the non-negative fp32 distance.
//
// nn_kernel is the one-directional search (ICP correspondences, the carry
// test): the same sweep with the row side only, so it needs no scratch and
// serves both a batch of 100 clouds of 5,000 points and one query set of
// 25,600 points against 2,048.  Threads read y straight from global memory:
// a warp's 32 columns are 384 contiguous bytes, every byte of which is used,
// and all blocks of a batch entry share them through L2.
//
// nn_bidir_acc_kernel is the indexed kernel for large clouds.  The TPU
// version accumulates the column (min, argmin) in one revisited (1, M) block
// across its ordered grid because the (tiles, M) block outgrows VMEM; here
// the same block outgrows nothing but costs 8 bytes per (tile, column),
// written and read back.  Blocks run in no order, so the accumulator is one
// 64-bit word per column, distance bits in the high half and x row index in
// the low half, merged with atomicMin: a non-negative fp32 orders as its
// bits, so the 64-bit minimum is the smallest distance and, among equal
// distances, the smallest row -- the first-index rule of the TPU kernel's
// strictly-less update (knn.py:263-268) in any block order.  A block first
// reads the word and skips the atomic when it cannot lower it (the word only
// ever decreases, so a stale read costs at most a needless atomic).
//
// Bound on the H100: fp32 ALU work, about 9 operations per (x, y) pair over
// S * N * M pairs (3 subtracts, 3 abs, 2 adds, the min updates); the
// indexed kernel adds the (S, tiles, M) partial traffic (8 bytes per entry,
// written once here and read once by the fold).  A first kernel, plain and
// exact: no tensor cores, no TMA.
//
// Bit-level parity.  The distance keeps the JAX order (knn.py:67-71):
// |x0-y0| + |x1-y1| + |x2-y2| (or d0*d0 + d1*d1 + d2*d2) summed left to
// right, every operation rounded on its own (__fadd_rn/__fmul_rn are never
// contracted into FMAs; the build also passes -fmad=false).  The plain
// PyTorch versions in ops/knn.py do the same elementwise operations, so
// distances are bit-identical and indices match exactly.

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
nn_bidir_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                float* __restrict__ dx, int64_t* __restrict__ ix,
                float* __restrict__ cmin, int* __restrict__ carg) {
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int row0 = tile * kTileRows;
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

  float* cmin_row = cmin + ((size_t)s * tiles + tile) * m;
  int* carg_row = carg + ((size_t)s * tiles + tile) * m;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float y0 = yb[3 * j], y1 = yb[3 * j + 1], y2 = yb[3 * j + 2];
    float cd = CUDART_INF_F;
    int ci = 0;
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float d = pair_dist<NORM>(xs[i], y0, y1, y2);
      if (d < rmin[i]) {
        rmin[i] = d;
        ridx[i] = j;
      }
      if (d < cd) {
        cd = d;
        ci = i;
      }
    }
    cmin_row[j] = cd;
    carg_row[j] = row0 + ci;
  }

  store_row_results(rmin, ridx, row0, n, dx + (size_t)s * n, ix + (size_t)s * n, red_d, red_i);
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

template <int NORM>
__global__ void __launch_bounds__(kThreads)
nn_bidir_acc_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                    float* __restrict__ dx, int64_t* __restrict__ ix,
                    unsigned long long* cpacked) {
  const int s = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const float* yb = y + (size_t)s * m * 3;
  unsigned long long* cp = cpacked + (size_t)s * m;

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
    float cd = CUDART_INF_F;
    int ci = 0;
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float d = pair_dist<NORM>(xs[i], y0, y1, y2);
      if (d < rmin[i]) {
        rmin[i] = d;
        ridx[i] = j;
      }
      if (d < cd) {
        cd = d;
        ci = i;
      }
    }
    // (distance bits, row) as one word; the tile's first row on ties is ci
    const unsigned long long word =
        ((unsigned long long)__float_as_uint(cd) << 32) | (unsigned int)(row0 + ci);
    if (word < *reinterpret_cast<volatile unsigned long long*>(cp + j)) atomicMin(cp + j, word);
  }
  store_row_results(rmin, ridx, row0, n, dx + (size_t)s * n, ix + (size_t)s * n, red_d, red_i);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface for ctypes.  Each launcher enqueues on the given stream, does
// not synchronise, allocates nothing, and returns cudaGetLastError().
// ---------------------------------------------------------------------------

extern "C" int knn_tile_rows() { return kTileRows; }

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64,
// cmin (S, tiles, M) f32 and carg (S, tiles, M) i32 per-tile column partials,
// tiles = ceil(N / knn_tile_rows()); carg holds global x row indices.
extern "C" int knn_bidir_launch(const float* x, const float* y, int s, int n, int m, int norm,
                                float* dx, int64_t* ix, float* cmin, int* carg,
                                void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileRows - 1) / kTileRows, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm == 1) {
    nn_bidir_kernel<1><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix, cmin, carg);
  } else if (norm == 2) {
    nn_bidir_kernel<2><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix, cmin, carg);
  } else {
    return (int)cudaErrorInvalidValue;
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

// x (S, N, 3), y (S, M, 3) -> dx (S, N) f32, ix (S, N) i64; cpacked (S, M)
// u64 must hold (bits of +inf) << 32 | 0x7fffffff on entry and holds, per y
// point, (bits of the column minimum) << 32 | x row index on exit.
extern "C" int knn_bidir_acc_launch(const float* x, const float* y, int s, int n, int m,
                                    int norm, float* dx, int64_t* ix,
                                    unsigned long long* cpacked, void* stream) {
  if (s <= 0 || n <= 0 || m <= 0 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileRows - 1) / kTileRows, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm == 1) {
    nn_bidir_acc_kernel<1><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix, cpacked);
  } else if (norm == 2) {
    nn_bidir_acc_kernel<2><<<grid, kThreads, 0, st>>>(x, y, n, m, dx, ix, cpacked);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
