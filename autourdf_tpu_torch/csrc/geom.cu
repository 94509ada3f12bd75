// Small geometry kernels for Hopper (sm_90a), fp32: the three operations
// that the JAX package runs inside its compiled programs and that PyTorch
// would run on the card only by waiting on the host.
//
//   fps_kernel           <- autourdf_tpu/ops/fps.py:17 farthest_point_sample
//                           (a fori_loop of k argmax steps)
//   kabsch3_kernel       <- autourdf_tpu/ops/icp.py:50 _kabsch
//                           (jnp.linalg.svd + det of the 3x3 cross-covariance)
//   sym_eig3_min_kernel  <- autourdf_tpu/ops/plane.py:56 estimate_normals
//                           (jnp.linalg.eigh of each 3x3 covariance)
//
// None of them replaces a Pallas kernel: XLA compiled these into the JAX
// programs.  PyTorch's torch.linalg.svd, det and eigh read the solver's
// status back to the host on CUDA, and the farthest-point loop is k Python
// steps of four or five kernels each, so none of them could sit inside a
// captured program (utils/programs.py) before.
//
// fps_kernel: the whole pick in one launch of one cluster of 16 blocks
// (1,024 threads each, on 16 SMs).  Each of the k steps is a pass over the
// points (the running minimum squared distance to the picks, then its
// argmax) and a reduction across the cluster, so a step is bound by the
// reads of the points and the synchronisation, not by the card's rates.
//   - Ownership by original index: block b owns indices [b R, (b + 1) R),
//     R = ceil(n / 16), and compacts its valid points stably into its own
//     shared memory at the start, each as a float4 (x, y, z, running
//     minimum at +inf), with its offset in the range beside it as 16 bits
//     (where R <= 65,536).  Up to about 12,900 points a block stay in shared
//     memory (227 KB): the 184,354 visible points of an 800-pixel capture
//     of the wx200 need at most 12,500.  The rest of a larger range stays in
//     the global scratch `work` and is streamed every step, still spread
//     over the 16 SMs.
//   - Keys: a point's key is its minimum's bits (non-negative, so ordered
//     as unsigned) above the complement of its index, and the argmax is the
//     largest key, so that equal distances go to the first index as
//     torch.argmax's do; a reduction takes the largest bits, then the
//     smallest index among them (two redux.sync a warp).  Inside a block
//     the index is the compact one (the compaction is stable, so its order
//     is the original one); the block's winner carries its original index
//     across the cluster.  Masked points never appear, so the largest key
//     is the plain version's first-index argmax over where(valid, d, -inf),
//     whatever the partition.  Step 0 is the same reduction with every
//     minimum at +inf: the first valid point.  With no valid point every
//     pick is 0, as torch.argmax of all -inf.
//   - One cluster barrier a step: each block reduces its winner (warps,
//     then one __syncthreads and warp 0), and warp 0's first 16 lanes push
//     it, (x, y, z, bits) and the original index, into its slot in every
//     block's shared memory (distributed shared memory stores, double-
//     buffered by the step's parity); after barrier.cluster every warp
//     reads the 16 slots from its own block and takes the largest: the
//     pick's coordinates need no global read.  A block writes a parity's
//     slots again only after the next barrier, which every reader of them
//     has passed.  (Pulling the slots instead, every warp reading the 16
//     blocks' slots, took 7.8 us a step at a capture's shape on the H100,
//     against 2.4: 512 remote loads an SM a step.)
//   - Where the time goes (H100, chip_smoke.py [3]): about 1 us a step
//     of shared-memory reads (16 bytes a point at 128 bytes a clock), the
//     rest the step's chain of reductions, barrier and slot reads, whose
//     floor of one empty cluster barrier is about 0.8 us.
// The distance rounds as the plain version's torch.sum((p - q) ** 2, dim=1)
// does on the card (fps_dist below) under -fmad=false, so the picks are the
// plain version's, bit for bit.  The launch sets the non-portable cluster
// size and the shared memory once (geom_fps_setup), before any capture.
//
// kabsch3_kernel and sym_eig3_min_kernel: one thread a 3x3 matrix, all in
// registers, fixed sweeps of cyclic Jacobi rotations (no data-dependent
// loop, no branch but the skip of a rotation whose off-diagonal entry is
// exactly zero).  Bound by the latency of a thread's dependent fp32 chain:
// the batches are 1 to 20,000 matrices, a fraction of one wave.
//   - Kabsch: H = U S V^T by one-sided Jacobi on H's columns (Hestenes:
//     the column pair's Gram entries are recomputed from the rotated
//     columns, so the squared condition number of H^T H never forms),
//     accumulating V; the columns sorted by norm, largest first (a swap
//     negates one column, so V stays a proper rotation); then B = H V
//     reduced to upper-triangular form by three Givens rotations, whose
//     product U is proper, with the first two diagonal entries non-negative
//     and the third carrying det's sign.  R = V U^T is then
//     V diag(1, 1, det(V U^T)) U^T of the plain version: the reflection
//     falls on the smallest singular value.  H = 0 rotates nothing: exactly
//     the identity.  (The same construction as McAdams et al. 2011,
//     "Computing the singular value decomposition of 3x3 matrices with
//     minimal branching", with exact rotations in place of its approximate
//     quaternion ones, which would turn a zero H.)
//   - Smallest eigenvector: two-sided cyclic Jacobi on the symmetric matrix,
//     accumulating the eigenvectors; the column of the smallest diagonal
//     entry (the first on ties), normalised.  Iterative, not the closed-form
//     trigonometric roots, which lose the vector when the two smallest
//     eigenvalues are close.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// farthest-point sampling
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kFpsCluster = 16;    // blocks, one cluster (non-portable size)
constexpr int kFpsThreads = 1024;
constexpr int kFpsWarps = kFpsThreads / 32;
// the largest range whose offsets fit in 16 bits beside the points
constexpr int kFpsSmallRange = 1 << 16;

// bits of -1.0f: "no point" (as signed ints, below the bits of every
// non-negative float)
constexpr int kFpsNone = static_cast<int>(0xbf800000u);

// torch.sum((p - q) ** 2, dim=1) over 3 columns on the card: the reduction
// gives a row two threads (the largest power of two <= 3), the first summing
// columns 0 and 2, the second holding column 1, then one shuffle:
// (x^2 + z^2) + y^2.  chip_smoke.py [3] holds the picks to the plain
// version's, bit for bit.
__device__ __forceinline__ float fps_dist(float4 p, float qx, float qy, float qz) {
  const float dx = p.x - qx, dy = p.y - qy, dz = p.z - qz;
  const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
  return (xx + zz) + yy;
}

// The largest key of a warp, as (bits of the minimum, index): the largest
// bits (as signed ints, which order non-negative floats and put kFpsNone
// below them), then the smallest index among them.  Two redux.sync.
__device__ __forceinline__ void warp_best(int& bits, unsigned& idx) {
  const int top = __reduce_max_sync(0xffffffffu, bits);
  idx = __reduce_min_sync(0xffffffffu, bits == top ? idx : 0xffffffffu);
  bits = top;
}

// One point's step: its running minimum against the last pick (stored where
// it falls) and the thread's best; strictly greater keeps the first index.
__device__ __forceinline__ void fps_visit(float4* cloud, int i, float qx, float qy, float qz,
                                          float& best, int& bi) {
  const float4 p = cloud[i];
  const float d = fps_dist(p, qx, qy, qz);
  if (d < p.w) reinterpret_cast<float*>(cloud)[4 * (size_t)i + 3] = d;
  const float m = fminf(p.w, d);
  if (m > best) {
    best = m;
    bi = i;
  }
}

// points (n, 3), mask (n,) or null -> out (k,) int64 indices into points.
// One cluster of kFpsCluster blocks; block b owns [b range, (b + 1) range)
// and keeps the first `cap` of its valid points in dynamic shared memory
// (cap float4, then cap 16-bit offsets where range <= kFpsSmallRange).
// Scratch: work (n,) float4 for the points beyond cap, orig (n,) int32
// original indices, both at the block's range.
__global__ void __launch_bounds__(kFpsThreads, 1) fps_kernel(
    const float* __restrict__ pts, const bool* __restrict__ mask, int n, int k, int range,
    int cap, float4* __restrict__ work, int* __restrict__ orig, int64_t* __restrict__ out) {
  extern __shared__ float4 fps_shared[];
  // the winners of the cluster's blocks, by step parity and block: (x, y, z,
  // bits of the minimum) and the original index, written by their blocks
  __shared__ float4 slot_p[2][kFpsCluster];
  __shared__ int slot_o[2][kFpsCluster];
  __shared__ int warp_bits[kFpsWarps];
  __shared__ unsigned warp_idx[kFpsWarps];
  __shared__ int warp_count[kFpsWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = static_cast<int>(cluster.block_rank());
  const bool small = range <= kFpsSmallRange;
  float4* sp = fps_shared;
  unsigned short* soff = reinterpret_cast<unsigned short*>(fps_shared + cap);
  const long long base = static_cast<long long>(b) * range;
  const int end = static_cast<int>(base + range < n ? base + range : n);
  float4* gwork = work + base;
  int* gorig = orig + base;

  // stable compaction of the block's valid points, a tile of kFpsThreads
  // at a time: the first cap to shared memory, the rest to work
  int count = 0;
  for (long long tile = base; tile < end; tile += kFpsThreads) {
    const int i = static_cast<int>(tile) + t;
    const bool valid = i < end && (mask == nullptr || mask[i]);
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kFpsWarps; ++w) {
      before += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (valid) {
      const int pos = count + before + __popc(ballot & ((1u << lane) - 1u));
      // the minimum starts at +inf: min(inf, d) = d
      const float4 p = make_float4(pts[3 * (size_t)i], pts[3 * (size_t)i + 1],
                                   pts[3 * (size_t)i + 2], __int_as_float(0x7f800000));
      if (pos < cap) {
        sp[pos] = p;
        if (small) soff[pos] = static_cast<unsigned short>(i - base);
      } else {
        gwork[pos] = p;
      }
      gorig[pos] = i;
    }
    count += total;
    __syncthreads();
  }
  const int held = count < cap ? count : cap;

  // step 0: every minimum is +inf, so a thread's best is its first point
  float best = -1.f;
  int bi = 0;
  if (t < count) {
    best = __int_as_float(0x7f800000);
    bi = t;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;   // the last pick
  for (int s = 0; s < k; ++s) {
    if (s > 0) {
      best = -1.f;
      for (int i = t; i < held; i += kFpsThreads) fps_visit(sp, i, qx, qy, qz, best, bi);
      for (int i = cap + t; i < count; i += kFpsThreads) fps_visit(gwork, i, qx, qy, qz, best, bi);
    }
    // the block's winner (compact index), then warp 0 pushes it, with its
    // coordinates and original index, into this step's slot of every block
    int bits = __float_as_int(best);
    unsigned idx = static_cast<unsigned>(bi);
    warp_best(bits, idx);
    if (lane == 0) {
      warp_bits[warp] = bits;
      warp_idx[warp] = idx;
    }
    __syncthreads();
    const int par = s & 1;
    if (warp == 0) {
      bits = warp_bits[lane];
      idx = warp_idx[lane];
      warp_best(bits, idx);
      float4 p = make_float4(0.f, 0.f, 0.f, __int_as_float(kFpsNone));
      int o = 0;
      if (bits != kFpsNone) {
        const int j = static_cast<int>(idx);
        const bool shared = j < cap;
        p = shared ? sp[j] : gwork[j];
        p.w = __int_as_float(bits);
        o = shared && small ? static_cast<int>(base) + soff[j] : gorig[j];
      }
      if (lane < kFpsCluster) {
        *cluster.map_shared_rank(&slot_p[par][b], lane) = p;
        *cluster.map_shared_rank(&slot_o[par][b], lane) = o;
      }
    }
    cluster.sync();
    // every warp takes the largest of the 16 slots, now in its own block
    int o = -1;
    bits = kFpsNone;
    if (lane < kFpsCluster) {
      bits = __float_as_int(slot_p[par][lane].w);
      o = slot_o[par][lane];
    }
    int top = bits;
    unsigned pick = static_cast<unsigned>(o);
    warp_best(top, pick);
    if (top == kFpsNone) {             // no valid point: torch.argmax of all -inf is 0
      if (b == 0) {
        for (int i = t; i < k; i += kFpsThreads) out[i] = 0;
      }
      break;
    }
    const int src = __ffs(__ballot_sync(0xffffffffu, bits == top && o == static_cast<int>(pick))) - 1;
    const float4 q = slot_p[par][src];
    qx = q.x;
    qy = q.y;
    qz = q.z;
    if (b == 0 && t == 0) out[s] = static_cast<int64_t>(pick);
  }
  // no block leaves while another may still write to its slots
  cluster.sync();
}

// k cluster barriers and nothing else, in fps_kernel's launch shape: the
// floor under a pick of k steps that synchronises once a step (a
// measurement for chip_smoke.py [3]; no path launches it)
__global__ void __launch_bounds__(kFpsThreads, 1) cluster_barriers_kernel(int k) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < k; ++s) cluster.sync();
}

// ---------------------------------------------------------------------------
// 3x3 Jacobi kernels
// ---------------------------------------------------------------------------

constexpr int kJacobiThreads = 128;
constexpr int kKabschSweeps = 6;
constexpr int kEigSweeps = 6;

// (c, s) of the Jacobi rotation that zeroes the pair's coupling `g` given its
// diagonal entries `a` (p) and `b` (q): t = sign(z) / (|z| + sqrt(1 + z^2)),
// z = (b - a) / (2 g), the smaller root (Golub and Van Loan, sym.schur2).
__device__ __forceinline__ void jacobi_cs(float a, float b, float g, float& c, float& s) {
  const float z = (b - a) / (2.f * g);
  const float t = copysignf(1.f, z) / (fabsf(z) + sqrtf(1.f + z * z));
  c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
}

// one-sided Jacobi step on columns p, q of B (and of V)
__device__ __forceinline__ void hestenes(float (&B)[3][3], float (&V)[3][3], int p, int q) {
  float a = 0.f, b = 0.f, g = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a += B[r][p] * B[r][p];
    b += B[r][q] * B[r][q];
    g += B[r][p] * B[r][q];
  }
  if (g == 0.f) return;
  float c, s;
  jacobi_cs(a, b, g, c, s);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bp = B[r][p], bq = B[r][q];
    B[r][p] = c * bp - s * bq;
    B[r][q] = s * bp + c * bq;
    const float vp = V[r][p], vq = V[r][q];
    V[r][p] = c * vp - s * vq;
    V[r][q] = s * vp + c * vq;
  }
}

// put the larger-norm column of p < q first: swap, negating the new column q
// (det of V stays +1, B = H V still holds)
__device__ __forceinline__ void order_columns(float (&B)[3][3], float (&V)[3][3], int p, int q) {
  float np = 0.f, nq = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    np += B[r][p] * B[r][p];
    nq += B[r][q] * B[r][q];
  }
  if (!(np < nq)) return;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float bp = B[r][p], vp = V[r][p];
    B[r][p] = B[r][q];
    B[r][q] = -bp;
    V[r][p] = V[r][q];
    V[r][q] = -vp;
  }
}

// Givens rotation of rows p, q of B zeroing B[q][col] (B[p][col] becomes
// the pair's norm, non-negative); U <- U G^T, so that B = U (G B) holds
__device__ __forceinline__ void givens(float (&B)[3][3], float (&U)[3][3], int p, int q, int col) {
  const float a = B[p][col], b = B[q][col];
  const float r = sqrtf(a * a + b * b);
  if (r == 0.f) return;
  const float c = a / r, s = b / r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float bp = B[p][j], bq = B[q][j];
    B[p][j] = c * bp + s * bq;
    B[q][j] = c * bq - s * bp;
    const float up = U[j][p], uq = U[j][q];
    U[j][p] = c * up + s * uq;
    U[j][q] = c * uq - s * up;
  }
}

// H (b, 3, 3) row-major -> R (b, 3, 3) = V diag(1, 1, det(V U^T)) U^T
__global__ void __launch_bounds__(kJacobiThreads) kabsch3_kernel(
    const float* __restrict__ H, float* __restrict__ R, int b) {
  const int m = blockIdx.x * kJacobiThreads + threadIdx.x;
  if (m >= b) return;
  float B[3][3], V[3][3], U[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      B[i][j] = H[9 * (size_t)m + 3 * i + j];
      V[i][j] = U[i][j] = i == j ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kKabschSweeps; ++sweep) {
    hestenes(B, V, 0, 1);
    hestenes(B, V, 0, 2);
    hestenes(B, V, 1, 2);
  }
  order_columns(B, V, 0, 1);
  order_columns(B, V, 0, 2);
  order_columns(B, V, 1, 2);
  givens(B, U, 0, 1, 0);
  givens(B, U, 0, 2, 0);
  givens(B, U, 1, 2, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[9 * (size_t)m + 3 * i + j] = (V[i][0] * U[j][0] + V[i][1] * U[j][1]) + V[i][2] * U[j][2];
    }
  }
}

// two-sided Jacobi rotation zeroing A[p][q] (r is the third index)
__device__ __forceinline__ void sym_rotate(float (&A)[3][3], float (&V)[3][3], int p, int q,
                                           int r) {
  const float g = A[p][q];
  if (g == 0.f) return;
  float c, s;
  jacobi_cs(A[p][p], A[q][q], g, c, s);
  const float t = s / c;
  A[p][p] -= t * g;
  A[q][q] += t * g;
  A[p][q] = A[q][p] = 0.f;
  const float arp = A[r][p], arq = A[r][q];
  A[r][p] = A[p][r] = c * arp - s * arq;
  A[r][q] = A[q][r] = s * arp + c * arq;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = V[i][p], vq = V[i][q];
    V[i][p] = c * vp - s * vq;
    V[i][q] = s * vp + c * vq;
  }
}

// C (n, 3, 3) symmetric, row-major -> out (n, 3): the unit eigenvector of
// the smallest eigenvalue
__global__ void __launch_bounds__(kJacobiThreads) sym_eig3_min_kernel(
    const float* __restrict__ C, float* __restrict__ out, int n) {
  const int m = blockIdx.x * kJacobiThreads + threadIdx.x;
  if (m >= n) return;
  float A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = C[9 * (size_t)m + 3 * i + j];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kEigSweeps; ++sweep) {
    sym_rotate(A, V, 0, 1, 2);
    sym_rotate(A, V, 0, 2, 1);
    sym_rotate(A, V, 1, 2, 0);
  }
  // the column of the smallest diagonal entry, the first on ties (selects,
  // not an index: V stays in registers)
  float least = A[0][0], x = V[0][0], y = V[1][0], z = V[2][0];
  if (A[1][1] < least) {
    least = A[1][1];
    x = V[0][1], y = V[1][1], z = V[2][1];
  }
  if (A[2][2] < least) {
    x = V[0][2], y = V[1][2], z = V[2][2];
  }
  const float inv = 1.f / sqrtf((x * x + y * y) + z * z);
  out[3 * (size_t)m] = x * inv;
  out[3 * (size_t)m + 1] = y * inv;
  out[3 * (size_t)m + 2] = z * inv;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes, ops/_cuda.py); each returns the launch's cudaError_t
// ---------------------------------------------------------------------------

namespace {
// fps_kernel's dynamic shared memory limit, set by geom_fps_setup
int g_fps_shared_max = -1;

// one cluster of kFpsCluster blocks of kFpsThreads; `cluster` must outlive
// the config
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& cluster, int shared_bytes,
                                  void* stream) {
  cluster = cudaLaunchAttribute{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kFpsCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kFpsCluster);
  cfg.blockDim = dim3(kFpsThreads);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cfg;
}
}  // namespace

// fps_kernel's shared plan for n points: returns the dynamic shared bytes a
// block and sets *cap, the points a block holds in shared memory (-1 before
// geom_fps_setup)
extern "C" int geom_fps_plan(int n, int* cap) {
  if (g_fps_shared_max < 0 || n <= 0) return -1;
  const int range = (n + kFpsCluster - 1) / kFpsCluster;
  const bool small = range <= kFpsSmallRange;
  int c = g_fps_shared_max / (small ? 18 : 16);
  c = c < range ? c : range;
  for (;;) {
    const int bytes = 16 * c + (small ? (2 * c + 15) / 16 * 16 : 0);
    if (bytes <= g_fps_shared_max) {
      *cap = c;
      return bytes;
    }
    --c;
  }
}

// Once a process, before the first launch and outside any capture: allow
// the non-portable cluster size and all of a block's opt-in shared memory,
// then ask how many such clusters the card can hold at once (0: the launch
// could never run).  Returns the cudaError_t; sets the clusters, the
// dynamic shared limit, the kernel's registers a thread and its local
// (spilled) bytes a thread.
extern "C" int geom_fps_setup(int* max_clusters, int* shared_max, int* regs, int* local_bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fps_kernel);
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_barriers_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, dyn, nullptr);
  err = cudaOccupancyMaxActiveClusters(max_clusters, fps_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_fps_shared_max = dyn;
  *shared_max = dyn;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// points (n, 3) f32, mask (n,) bool or null -> out (k,) int64; work (n,)
// float4 and orig (n,) int32 are scratch.  One launch of one cluster.
extern "C" int geom_fps_launch(const float* points, const bool* mask, int n, int k,
                               void* work, int* orig, int64_t* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  const int bytes = geom_fps_plan(n, &cap);
  if (bytes < 0) return (int)cudaErrorInitializationError;   // geom_fps_setup first
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, bytes, stream);
  const int range = (n + kFpsCluster - 1) / kFpsCluster;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fps_kernel, points, mask, n, k, range, cap,
                                       static_cast<float4*>(work), orig, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// k empty cluster barriers in fps_kernel's launch shape (after
// geom_fps_setup)
extern "C" int geom_cluster_barriers_launch(int k, void* stream) {
  if (k <= 0 || g_fps_shared_max < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 0, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_barriers_kernel, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// H (b, 3, 3) f32 -> R (b, 3, 3) f32
extern "C" int geom_kabsch3_launch(const float* H, float* R, int b, void* stream) {
  if (b <= 0) return (int)cudaErrorInvalidValue;
  kabsch3_kernel<<<(b + kJacobiThreads - 1) / kJacobiThreads, kJacobiThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(H, R, b);
  return (int)cudaGetLastError();
}

// C (n, 3, 3) f32 symmetric -> out (n, 3) f32
extern "C" int geom_sym_eig3_min_launch(const float* C, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  sym_eig3_min_kernel<<<(n + kJacobiThreads - 1) / kJacobiThreads, kJacobiThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(C, out, n);
  return (int)cudaGetLastError();
}
