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
// fps_kernel: the whole pick in one launch of one block.  Each of the k
// steps is a pass over the points (the running minimum squared distance to
// the picks, then its argmax) and a block-wide reduction, so the steps are
// bound by the block's two barriers and its reads of the cloud from L2, not
// by the card's rates: one block of 1,024 threads a cloud, each point packed
// as a float4 with its running minimum in the fourth lane, in device memory
// (16 bytes a point: the 184,354 visible points of an 800-pixel capture of
// the wx200 are 2.9 MB, resident in L2), read once a step and written only
// where the minimum falls.  The argmax is a maximum of
// 64-bit keys, the distance's bits (non-negative, so ordered as unsigned)
// above the complement of the index, so that equal distances go to the
// first index as torch.argmax's do.  A mask is applied once, by a stable
// compaction of the valid points into the scratch cloud at the start; the
// picks are mapped back to the caller's indices.  The distance rounds as
// the plain version's torch.sum((p - q) ** 2, dim=1) does on the card
// (fps_dist below) under -fmad=false, so the picks are the plain
// version's, bit for bit.  A cluster of blocks holding the cloud in
// distributed shared memory is later work.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// farthest-point sampling
// ---------------------------------------------------------------------------

constexpr int kFpsThreads = 1024;
constexpr int kFpsWarps = kFpsThreads / 32;

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

__device__ __forceinline__ unsigned long long fps_key(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(~i);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// points (n, 3), mask (n,) or null -> out (k,) int64 indices into points.
// Scratch: work (n,) float4 (x, y, z, running minimum), orig (n,) int32.
// One block.
__global__ void __launch_bounds__(kFpsThreads) fps_kernel(
    const float* __restrict__ pts, const bool* __restrict__ mask, int n, int k,
    float4* __restrict__ work, int* __restrict__ orig, int64_t* __restrict__ out) {
  __shared__ int warp_count[kFpsWarps];
  __shared__ unsigned long long warp_best[kFpsWarps];
  __shared__ unsigned long long pick;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // stable compaction of the valid points, a tile of kFpsThreads at a time
  int count = 0;
  for (int base = 0; base < n; base += kFpsThreads) {
    const int i = base + t;
    const bool valid = i < n && (mask == nullptr || mask[i]);
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
      work[pos] = make_float4(pts[3 * (size_t)i], pts[3 * (size_t)i + 1],
                              pts[3 * (size_t)i + 2], __int_as_float(0x7f800000));
      orig[pos] = i;
    }
    count += total;
    __syncthreads();
  }
  if (count == 0) {                  // no valid point: torch.argmax of all -inf is 0
    for (int s = t; s < k; s += kFpsThreads) out[s] = 0;
    return;
  }
  if (t == 0) out[0] = orig[0];
  float4 q = work[0];
  for (int s = 1; s < k; ++s) {
    unsigned long long best = 0;
    for (int i = t; i < count; i += kFpsThreads) {
      const float4 p = work[i];
      const float d = fps_dist(p, q.x, q.y, q.z);
      if (d < p.w) reinterpret_cast<float*>(work)[4 * (size_t)i + 3] = d;
      const unsigned long long key = fps_key(fminf(p.w, d), i);
      best = key > best ? key : best;
    }
    best = warp_max(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_max(lane < kFpsWarps ? warp_best[lane] : 0ull);
      if (lane == 0) pick = best;
    }
    __syncthreads();
    const int next = static_cast<int>(~static_cast<unsigned int>(pick & 0xffffffffull));
    q = work[next];
    if (t == 0) out[s] = orig[next];
  }
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

// points (n, 3) f32, mask (n,) bool or null -> out (k,) int64; work (n,)
// float4 and orig (n,) int32 are scratch.  One launch.
extern "C" int geom_fps_launch(const float* points, const bool* mask, int n, int k,
                               void* work, int* orig, int64_t* out, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  fps_kernel<<<1, kFpsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, mask, n, k, static_cast<float4*>(work), orig, out);
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
