// Geometry kernels for Hopper (sm_90a), fp32: the operations that the JAX
// package runs inside its compiled programs and that PyTorch would run on
// the card only as many small kernels or by waiting on the host.
//
//   fps_kernel          <- autourdf_tpu/ops/fps.py:17 farthest_point_sample
//                          (a fori_loop of k argmax steps)
//   icp_kabsch_kernel   <- autourdf_tpu/ops/icp.py:50 _kabsch + :102-121 step
//                          (gating, weighted means, H, jnp.linalg.svd + det,
//                          Newton-Schulz, fitness, RMSE, convergence freeze)
//   pca_normals_kernel  <- autourdf_tpu/ops/plane.py:79-88 estimate_normals
//                          (gather, mean, covariance, jnp.linalg.eigh, flip)
//
// None of them replaces a Pallas kernel: XLA compiled these into the JAX
// programs.  PyTorch's torch.linalg.svd, det and eigh read the solver's
// status back to the host on CUDA, and the farthest-point loop is k Python
// steps of four or five kernels each, so none of them could sit inside a
// captured program (utils/programs.py) before.

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
// icp_kabsch_kernel: everything of an ICP iteration after the search, one
// launch for the whole batch, in place of the ~70 small kernels of the plain
// step (ops/icp.py _kabsch_step_plain).  Bound by bytes: a point's moved
// (12), index (8), gathered match (12), d2 (4) and weight (4), plus its
// source (12) and next moved (12) written; at the small batches of the link,
// polish and resim ICPs by the launch and the two cluster barriers.
//   - One cluster an entry of ceil(n / 2,048) blocks of 256 threads (at most
//     8, portable), a partition fixed by n alone: block r owns the points
//     [r R, (r + 1) R), R = ceil(n / blocks), thread t the points t + 256 j
//     of them, its first 8 kept in registers across both passes.
//   - Pass 1 sums w, s w, d w and w d2 (w = src_w (sqrt(d2) < threshold),
//     the threshold read from device memory, so one captured program serves
//     every threshold); pass 2 the centred H = sum ((s - s_mean) w)
//     (d - d_mean)^T, two passes as the JAX _kabsch: the one-pass
//     sum w s d^T - W s_mean d_mean^T cancels in fp32 when a link sits far
//     from the origin.
//   - Each sum in a fixed order, no atomics: a thread's points in order, a
//     shuffle tree in each warp, the warps in order into the block's shared
//     memory; after a cluster barrier every block reads the cluster's
//     partials through distributed shared memory in rank order, so every
//     block holds the same totals, bit for bit, and a run gives the same
//     bits every time.
//   - The 3x3 work on one thread: H = U S V^T by one-sided Jacobi on H's
//     columns (Hestenes: the column pair's Gram entries are recomputed from
//     the rotated columns, so the squared condition number of H^T H never
//     forms), accumulating V; the columns sorted by norm, largest first (a
//     swap negates one column, so V stays a proper rotation); then B = H V
//     reduced to upper-triangular form by three Givens rotations, whose
//     product U is proper, with the first two diagonal entries non-negative
//     and the third carrying det's sign.  R = V U^T is then
//     V diag(1, 1, det(V U^T)) U^T of the plain version: the reflection
//     falls on the smallest singular value.  H = 0 (no inlier, an empty
//     gate) rotates nothing: exactly the identity, so T keeps its init.
//     (The construction of McAdams et al. 2011, "Computing the singular
//     value decomposition of 3x3 matrices with minimal branching", with
//     exact rotations in place of its approximate quaternion ones, which
//     would turn a zero H.)  Then the four Newton-Schulz steps, T, fitness,
//     RMSE, the relative criteria and the freeze; rank 0 writes them.
//   - Every block solves the same 3x3 (the same bits) and writes its own
//     points' next moved, source T^T of the frozen T, so the loop needs no
//     transform kernels between iterations (H100: 27.3 us against 56.9 us
//     for the kernel without it plus the plain transform at B = 100,
//     PERF.md Table 2).
//
// pca_normals_kernel: a point a thread, 32 a block (about 156 blocks at the
// 4,988 points of a real frame, all 132 SMs).  The block's 32 x k indices,
// one contiguous range, come into shared memory by 16-byte cp.async; each
// thread issues the loads of its row's first 32 neighbours together
// (through the read-only path) and keeps them in registers for both sums
// (the k-neighbour mean, then the six sums of the centred covariance, each
// in neighbour order), then cyclic Jacobi (two-sided, 6 sweeps,
// accumulating the eigenvectors), the column of the smallest diagonal entry
// (the first on ties), normalised, flipped towards +z.  Iterative, not the
// closed-form trigonometric roots, which lose the vector when the two
// smallest eigenvalues are close.  Bound by bytes: the indices, 8 k a point.
// Measured against other designs (scripts/pca_normals_designs.cu; H100
// 80GB HBM3 at 700 W, PERF.md Table 2): walking the row twice, a load at a
// time, took 11.3 us at 4,988 points against 8.4 us; several lanes a point
// (4, 8 or 16, a shuffle butterfly), one solver thread after 8 lanes, or
// the whole cloud staged in shared memory took 8.1-10.5 us, none clearly
// ahead: each point's own chain of work, not its loads, sets the time.

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
// 3x3 solves (device functions) and the two fused kernels around them
// ---------------------------------------------------------------------------

constexpr int kKabschSweeps = 6;
constexpr int kEigSweeps = 6;
constexpr int kNewtonSchulz = 4;      // ops/icp.py _orthonormalize

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

// B holds H (row-major) and is overwritten -> R = V diag(1, 1, det(V U^T)) U^T
// of H = U S V^T
__device__ __forceinline__ void kabsch3(float (&B)[3][3], float (&R)[3][3]) {
  float V[3][3], U[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = U[i][j] = i == j ? 1.f : 0.f;
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
    for (int j = 0; j < 3; ++j)
      R[i][j] = (V[i][0] * U[j][0] + V[i][1] * U[j][1]) + V[i][2] * U[j][2];
  }
}

// R <- 1.5 R - 0.5 (R R^T) R, kNewtonSchulz times (ops/icp.py _orthonormalize)
__device__ __forceinline__ void newton_schulz(float (&R)[3][3]) {
#pragma unroll 1
  for (int step = 0; step < kNewtonSchulz; ++step) {
    float P[3][3], Q[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        P[i][j] = (R[i][0] * R[j][0] + R[i][1] * R[j][1]) + R[i][2] * R[j][2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Q[i][j] = (P[i][0] * R[0][j] + P[i][1] * R[1][j]) + P[i][2] * R[2][j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = 1.5f * R[i][j] - 0.5f * Q[i][j];
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

// A symmetric (overwritten) -> (x, y, z), the unit eigenvector of its
// smallest eigenvalue: the column of the smallest diagonal entry after the
// sweeps, the first on ties (selects, not an index: V stays in registers)
__device__ __forceinline__ void sym_eig3_min(float (&A)[3][3], float& x, float& y, float& z) {
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.f : 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kEigSweeps; ++sweep) {
    sym_rotate(A, V, 0, 1, 2);
    sym_rotate(A, V, 0, 2, 1);
    sym_rotate(A, V, 1, 2, 0);
  }
  float least = A[0][0];
  x = V[0][0], y = V[1][0], z = V[2][0];
  if (A[1][1] < least) {
    least = A[1][1];
    x = V[0][1], y = V[1][1], z = V[2][1];
  }
  if (A[2][2] < least) {
    x = V[0][2], y = V[1][2], z = V[2][2];
  }
  const float inv = 1.f / sqrtf((x * x + y * y) + z * z);
  x *= inv;
  y *= inv;
  z *= inv;
}

// ---------------------------------------------------------------------------
// icp_kabsch_kernel: one ICP iteration after the search
// ---------------------------------------------------------------------------

constexpr int kIcpThreads = 256;
constexpr int kIcpWarps = kIcpThreads / 32;
constexpr int kIcpMaxCluster = 8;       // the portable cluster size
constexpr int kIcpBlockPoints = 2048;   // ceil(n / this) blocks a cluster, at most kIcpMaxCluster
constexpr int kIcpRegPoints = 8;        // a thread's first points, in registers for both passes
constexpr int kIcpSums1 = 8;            // sum w, sum s w (3), sum d w (3), sum w d2
constexpr int kIcpSums2 = 9;            // H

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v summed over the block into out[0, NS) (shared), in a fixed order: in each
// warp a shuffle tree (lane l + off into lane l, off = 16, 8, 4, 2, 1), then
// the warps in order.  scratch: kIcpWarps x NS floats of shared memory.
template <int NS>
__device__ __forceinline__ void block_sums(float (&v)[NS], float* scratch, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[s] += __shfl_down_sync(0xffffffffu, v[s], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) scratch[warp * NS + s] = v[s];
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kIcpWarps; ++w) acc += scratch[w * NS + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// tot[0, NS) = the sum of every block's part[0, NS) in rank order, read
// through distributed shared memory (after a cluster barrier), so every
// block of the cluster holds the same totals, bit for bit
template <int NS>
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, float* part, float* tot) {
  if (threadIdx.x < NS) {
    float acc = 0.f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      acc += *cluster.map_shared_rank(part + threadIdx.x, r);
    tot[threadIdx.x] = acc;
  }
}

// point i of the entry: moved s, its match d = tgt[idx], the gated weight
// w = src_w (sqrt(max(d2, 0)) < threshold) and d2
__device__ __forceinline__ void icp_point(const float* mv, const float* tg, const int64_t* ix,
                                          const float* dd, const float* sw, int i, float thr,
                                          float (&s)[3], float (&d)[3], float& w, float& e2) {
  const int64_t q = ix[i];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s[r] = mv[3 * (size_t)i + r];
    d[r] = tg[3 * q + r];
  }
  e2 = dd[i];
  w = sw[i] * (sqrtf(fmaxf(e2, 0.f)) < thr ? 1.f : 0.f);
}

__device__ __forceinline__ void icp_first_sums(float (&acc)[kIcpSums1], const float (&s)[3],
                                               const float (&d)[3], float w, float e2) {
  acc[0] += w;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    acc[1 + r] += s[r] * w;
    acc[4 + r] += d[r] * w;
  }
  acc[7] += w * e2;
}

// H += ((s - s_mean) w) (d - d_mean)^T
__device__ __forceinline__ void icp_cross_sums(float (&h)[kIcpSums2], const float (&s)[3],
                                               const float (&d)[3], float w, const float* sm,
                                               const float* dm) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float sa = (s[a] - sm[a]) * w;
#pragma unroll
    for (int b = 0; b < 3; ++b) h[3 * a + b] += sa * (d[b] - dm[b]);
  }
}

// One cluster of ceil(n / range) blocks an entry; block `rank` owns the
// points [rank range, (rank + 1) range), thread t the points t + j
// kIcpThreads of them.  Pass 1: the weights and sums of w, s w, d w, w d2;
// the means; pass 2: the centred H; then the rotation, T, fitness, RMSE,
// convergence and freeze of ops/icp.py _kabsch_step_plain; every block
// then writes its points' next moved, source T[:3, :3]^T + T[:3, 3] of the
// frozen T, over `moved`.
__global__ void __launch_bounds__(kIcpThreads) icp_kabsch_kernel(
    const float* __restrict__ source, float* moved, const float* __restrict__ tgt,
    const int64_t* __restrict__ idx, const float* __restrict__ d2,
    const float* __restrict__ src_w, const float* __restrict__ src_total,
    const float* __restrict__ threshold, const float* __restrict__ rel_rmse,
    const float* __restrict__ rel_fitness, float* __restrict__ T, float* __restrict__ fitness,
    float* __restrict__ rmse, bool* __restrict__ done, int n, int m, int range) {
  __shared__ float scratch[kIcpWarps * kIcpSums2];
  __shared__ float part1[kIcpSums1], tot1[kIcpSums1], part2[kIcpSums2], tot2[kIcpSums2];
  // the entry's T, fitness, rmse and done as they were, then the frozen T
  __shared__ float state[19], T_next[12];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int e = blockIdx.x / cluster.num_blocks();
  const int t = threadIdx.x;
  const int base = rank * range;
  const int end = base + range < n ? base + range : n;
  const size_t row = static_cast<size_t>(e) * n;
  const float* mv = moved + 3 * row;
  const float* tg = tgt + 3 * static_cast<size_t>(e) * m;
  const int64_t* ix = idx + row;
  const float* dd = d2 + row;
  const float* sw = src_w + row;
  const float thr = *threshold;
  // read before the first cluster barrier; rank 0 writes after the last
  if (t < 16) state[t] = T[16 * static_cast<size_t>(e) + t];
  if (t == 16) state[16] = fitness[e];
  if (t == 17) state[17] = rmse[e];
  if (t == 18) state[18] = done[e] ? 1.f : 0.f;

  // pass 1
  float s[kIcpRegPoints][3], d[kIcpRegPoints][3], w[kIcpRegPoints];
  float acc[kIcpSums1];
#pragma unroll
  for (int k = 0; k < kIcpSums1; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kIcpRegPoints; ++j) {
    const int i = base + t + j * kIcpThreads;
    w[j] = 0.f;
    if (i < end) {
      float e2;
      icp_point(mv, tg, ix, dd, sw, i, thr, s[j], d[j], w[j], e2);
      icp_first_sums(acc, s[j], d[j], w[j], e2);
    }
  }
  for (int i = base + t + kIcpRegPoints * kIcpThreads; i < end; i += kIcpThreads) {
    float ps[3], pd[3], pw, e2;
    icp_point(mv, tg, ix, dd, sw, i, thr, ps, pd, pw, e2);
    icp_first_sums(acc, ps, pd, pw, e2);
  }
  block_sums<kIcpSums1>(acc, scratch, part1);
  cluster.sync();
  cluster_sums<kIcpSums1>(cluster, part1, tot1);
  __syncthreads();
  const float wsum = fmaxf(tot1[0], 1e-12f);
  float sm[3], dm[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    sm[r] = tot1[1 + r] / wsum;
    dm[r] = tot1[4 + r] / wsum;
  }

  // pass 2
  float h[kIcpSums2];
#pragma unroll
  for (int k = 0; k < kIcpSums2; ++k) h[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kIcpRegPoints; ++j) {
    if (base + t + j * kIcpThreads < end) icp_cross_sums(h, s[j], d[j], w[j], sm, dm);
  }
  for (int i = base + t + kIcpRegPoints * kIcpThreads; i < end; i += kIcpThreads) {
    float ps[3], pd[3], pw, e2;
    icp_point(mv, tg, ix, dd, sw, i, thr, ps, pd, pw, e2);
    icp_cross_sums(h, ps, pd, pw, sm, dm);
  }
  block_sums<kIcpSums2>(h, scratch, part2);
  cluster.sync();
  cluster_sums<kIcpSums2>(cluster, part2, tot2);
  // this block reads no other block's shared memory from here on; the wait
  // at the end keeps every block's partials alive until all have read them
  cluster_arrive();
  __syncthreads();

  if (t == 0) {
    float B[3][3], R[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) B[a][b] = tot2[3 * a + b];
    }
    kabsch3(B, R);
    newton_schulz(R);
    // T_new = [R | d_mean - R s_mean] T; its last row is T's
    float Tn[16];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ta = dm[a] - ((R[a][0] * sm[0] + R[a][1] * sm[1]) + R[a][2] * sm[2]);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        Tn[4 * a + b] = ((R[a][0] * state[b] + R[a][1] * state[4 + b]) + R[a][2] * state[8 + b])
                        + ta * state[12 + b];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) Tn[12 + b] = state[12 + b];
    const float fit = tot1[0] / src_total[e];
    const float err = sqrtf(tot1[7] / fmaxf(tot1[0], 1e-12f));
    const bool conv = fabsf(fit - state[16]) < *rel_fitness * fmaxf(fit, 1e-12f) &&
                      fabsf(err - state[17]) < *rel_rmse * fmaxf(err, 1e-12f);
    const bool frozen = state[18] != 0.f;
#pragma unroll
    for (int q = 0; q < 12; ++q) T_next[q] = frozen ? state[q] : Tn[q];
    if (rank == 0) {
#pragma unroll
      for (int q = 0; q < 16; ++q) T[16 * static_cast<size_t>(e) + q] = frozen ? state[q] : Tn[q];
      if (!frozen) {
        fitness[e] = fit;
        rmse[e] = err;
      }
      done[e] = frozen || conv;
    }
  }
  __syncthreads();
  const float* src = source + 3 * row;
  float* out = moved + 3 * row;
  for (int i = base + t; i < end; i += kIcpThreads) {
    const float x = src[3 * (size_t)i], y = src[3 * (size_t)i + 1], z = src[3 * (size_t)i + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* tr = T_next + 4 * r;
      out[3 * (size_t)i + r] = ((x * tr[0] + y * tr[1]) + z * tr[2]) + tr[3];
    }
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// pca_normals_kernel: the normal of each point's k-neighbourhood
// ---------------------------------------------------------------------------

constexpr int kPcaPoints = 32;    // points (threads) a block: 5,000 points reach every SM
constexpr int kPcaMaxK = 192;     // a block's kPcaPoints x k indices in 48 KB of shared memory
constexpr int kPcaRegs = 32;      // a row's first neighbours, loaded together, kept in registers

// points (n, 3), idx (n, k) int64 (16-byte aligned) -> out (n, 3): the
// smallest-eigenvalue eigenvector of the centred covariance of the k points
// idx[i], unit, flipped towards +z.  The block's rows of idx are one
// contiguous range, staged into shared memory with 16-byte cp.async; each
// thread then loads its row's first kPcaRegs neighbours together (the rest,
// if k is larger, once a sum) and sums them in order twice (mean, then the
// six sums of the covariance).
__global__ void __launch_bounds__(kPcaPoints) pca_normals_kernel(
    const float* __restrict__ pts, const int64_t* __restrict__ idx, int n, int k,
    float* __restrict__ out) {
  extern __shared__ __align__(16) int64_t pca_idx[];
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kPcaPoints;
  const int rows = n - first < kPcaPoints ? static_cast<int>(n - first) : kPcaPoints;
  const int count = rows * k;
  const int64_t* src = idx + first * k;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(pca_idx));
  for (int c = t; c < count / 2; c += kPcaPoints)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst + 16 * c), "l"(src + 2 * c) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if ((count & 1) && t == 0) pca_idx[count - 1] = src[count - 1];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (t >= rows) return;
  const int64_t* nb = pca_idx + t * k;
  float px[kPcaRegs], py[kPcaRegs], pz[kPcaRegs];
#pragma unroll
  for (int j = 0; j < kPcaRegs; ++j) {
    if (j < k) {
      const float* p = pts + 3 * nb[j];
      px[j] = __ldg(p);
      py[j] = __ldg(p + 1);
      pz[j] = __ldg(p + 2);
    }
  }
  float mx = 0.f, my = 0.f, mz = 0.f;
#pragma unroll
  for (int j = 0; j < kPcaRegs; ++j) {
    if (j < k) {
      mx += px[j];
      my += py[j];
      mz += pz[j];
    }
  }
  for (int j = kPcaRegs; j < k; ++j) {
    const float* p = pts + 3 * nb[j];
    mx += __ldg(p);
    my += __ldg(p + 1);
    mz += __ldg(p + 2);
  }
  const float fk = static_cast<float>(k);
  mx /= fk;
  my /= fk;
  mz /= fk;
  float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f;
  const auto add = [&](float x, float y, float z) {
    x -= mx;
    y -= my;
    z -= mz;
    c00 += x * x;
    c01 += x * y;
    c02 += x * z;
    c11 += y * y;
    c12 += y * z;
    c22 += z * z;
  };
#pragma unroll
  for (int j = 0; j < kPcaRegs; ++j) {
    if (j < k) add(px[j], py[j], pz[j]);
  }
  for (int j = kPcaRegs; j < k; ++j) {
    const float* p = pts + 3 * nb[j];
    add(__ldg(p), __ldg(p + 1), __ldg(p + 2));
  }
  float A[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  float x, y, z;
  sym_eig3_min(A, x, y, z);
  if (z < 0.f) {
    x = -x;
    y = -y;
    z = -z;
  }
  float* o = out + 3 * (first + t);
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes, ops/_cuda.py); each returns the launch's cudaError_t
// ---------------------------------------------------------------------------

namespace {
// fps_kernel's dynamic shared memory limit, set by geom_fps_setup
int g_fps_shared_max = -1;

// a launch of `grid` blocks of `threads` in clusters of `blocks`; `cluster`
// must outlive the config
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& cluster, int blocks, int grid, int threads,
                                  int shared_bytes, void* stream) {
  cluster = cudaLaunchAttribute{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// fps_kernel's launch: one cluster of kFpsCluster blocks of kFpsThreads
cudaLaunchConfig_t fps_config(cudaLaunchAttribute& cluster, int shared_bytes, void* stream) {
  return cluster_config(cluster, kFpsCluster, kFpsCluster, kFpsThreads, shared_bytes, stream);
}

// icp_kabsch_kernel's blocks a cluster for entries of n points
int icp_cluster_blocks(int n) {
  const int c = (n + kIcpBlockPoints - 1) / kIcpBlockPoints;
  return c < 1 ? 1 : (c > kIcpMaxCluster ? kIcpMaxCluster : c);
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
  const cudaLaunchConfig_t cfg = fps_config(cluster, dyn, nullptr);
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
  const cudaLaunchConfig_t cfg = fps_config(cluster, bytes, stream);
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
  const cudaLaunchConfig_t cfg = fps_config(cluster, 0, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_barriers_kernel, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Once a process, before the first launch and outside any capture: how many
// clusters of 1, ..., kIcpMaxCluster blocks of icp_kabsch_kernel the card
// holds at once (max_clusters[c - 1]; 0: that launch could never run), the
// kernel's registers a thread and its local (spilled) bytes a thread.
// Returns the cudaError_t.
extern "C" int geom_icp_kabsch_setup(int* max_clusters, int* regs, int* local_bytes) {
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, icp_kabsch_kernel);
  for (int c = 1; err == cudaSuccess && c <= kIcpMaxCluster; ++c) {
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = cluster_config(cluster, c, c, kIcpThreads, 0, nullptr);
    err = cudaOccupancyMaxActiveClusters(&max_clusters[c - 1], icp_kabsch_kernel, &cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// One ICP iteration after the search, for b entries of n points against m:
// source (b, n, 3), moved (b, n, 3) (in, then the next moved out),
// tgt (b, m, 3), idx (b, n) int64, d2, src_w (b, n), src_total (b,), the
// threshold and the relative RMSE and fitness criteria (one float each, on
// the device); T (b, 4, 4), fitness, rmse (b,) and done (b,) bool are read
// and written in place.  One cluster an entry.
extern "C" int geom_icp_kabsch_launch(const float* source, float* moved, const float* tgt,
                                      const int64_t* idx, const float* d2, const float* src_w,
                                      const float* src_total, const float* threshold,
                                      const float* rel_rmse, const float* rel_fitness, float* T,
                                      float* fitness, float* rmse, bool* done, int b, int n, int m,
                                      void* stream) {
  if (b <= 0 || n <= 0 || m <= 0 || source == nullptr) return (int)cudaErrorInvalidValue;
  const int c = icp_cluster_blocks(n);
  const int range = (n + c - 1) / c;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, c, b * c, kIcpThreads, 0, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, icp_kabsch_kernel, source, moved, tgt, idx, d2,
                                       src_w, src_total, threshold, rel_rmse, rel_fitness, T,
                                       fitness, rmse, done, n, m, range);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// points (n, 3) f32, idx (n, k) int64, 16-byte aligned -> out (n, 3) f32
extern "C" int geom_pca_normals_launch(const float* points, const int64_t* idx, int n, int k,
                                       float* out, void* stream) {
  if (n <= 0 || k <= 0 || k > kPcaMaxK) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(idx) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  pca_normals_kernel<<<(n + kPcaPoints - 1) / kPcaPoints, kPcaPoints,
                       kPcaPoints * k * static_cast<int>(sizeof(int64_t)),
                       static_cast<cudaStream_t>(stream)>>>(points, idx, n, k, out);
  return (int)cudaGetLastError();
}
