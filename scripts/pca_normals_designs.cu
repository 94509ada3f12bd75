// Designs of the normals' PCA kernel (autourdf_tpu_torch/csrc/geom.cu
// pca_normals_kernel), each a whole kernel: the k-neighbour mean, the six
// sums of the centred covariance, sym_eig3_min (geom.cu, unchanged), the
// flip towards +z.  scripts/torch_icp_bench.py --designs builds this file
// with the port's nvcc flags and times every design against the port's
// kernel on the same inputs; none of them is on a path of the port.
//
// Every design stages its block's rows of the neighbour indices (one
// contiguous range) into shared memory by 16-byte cp.async, as the port's
// kernel does, and serves 32 points a block.
//   thread              a point a thread, 32 threads a block, each walking its
//                       row twice through the read-only path, a load at a
//                       time (the first design of pca_normals_kernel)
//   lanes<G>            G lanes a point (32 G threads a block): lane l sums the
//                       neighbours l, l + G, ... (its first 32 / G kept in
//                       registers for the second pass), then a butterfly of
//                       shuffles (xor G / 2, ..., 1) gives every lane of the
//                       point the same sums, bit for bit; every lane solves
//                       the 3x3, lane 0 writes.  lanes<1> is the thread
//                       design with a row's loads issued together: the
//                       port's pca_normals_kernel, the same bits.
//   lanes<8> solver     the sums as lanes<8>, then one thread a point solves
//                       the 3x3 (the six sums through shared memory)
//   lanes<8> cloud      lanes<8> with the whole cloud staged into the block's
//                       shared memory first (up to about 18,000 points)
//
// Build: nvcc <autourdf_tpu_torch/ops/_cuda.py NVCC_FLAGS> -o lib.so
//        scripts/pca_normals_designs.cu

#include "../autourdf_tpu_torch/csrc/geom.cu"

namespace {

constexpr int kDesignPoints = 32;   // points a block, every design

// the block's rows of idx into shared memory (16-byte cp.async; idx 16-byte
// aligned), then the cloud where `cloud` is given (n * 3 floats, pts
// 16-byte aligned)
__device__ __forceinline__ void stage(int64_t* sidx, const int64_t* src, int count,
                                      float* cloud, const float* pts, int n) {
  const int t = threadIdx.x, step = blockDim.x;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sidx));
  for (int c = t; c < count / 2; c += step)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst + 16 * c), "l"(src + 2 * c) : "memory");
  if (cloud != nullptr) {
    const unsigned cdst = static_cast<unsigned>(__cvta_generic_to_shared(cloud));
    for (int c = t; c < 3 * n / 4; c += step)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(cdst + 16 * c), "l"(pts + 4 * c) : "memory");
    for (int c = 3 * n / 4 * 4 + t; c < 3 * n; c += step) cloud[c] = pts[c];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if ((count & 1) && t == 0) sidx[count - 1] = src[count - 1];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void solve_and_flip(float c00, float c01, float c02, float c11,
                                               float c12, float c22, float* o) {
  float A[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  float x, y, z;
  sym_eig3_min(A, x, y, z);
  if (z < 0.f) {
    x = -x;
    y = -y;
    z = -z;
  }
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

__global__ void __launch_bounds__(kDesignPoints) pca_thread_kernel(
    const float* __restrict__ pts, const int64_t* __restrict__ idx, int n, int k,
    float* __restrict__ out) {
  extern __shared__ __align__(16) int64_t design_idx[];
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kDesignPoints;
  const int rows = n - first < kDesignPoints ? static_cast<int>(n - first) : kDesignPoints;
  stage(design_idx, idx + first * k, rows * k, nullptr, pts, n);
  if (t >= rows) return;
  const int64_t* nb = design_idx + t * k;
  float mx = 0.f, my = 0.f, mz = 0.f;
  for (int j = 0; j < k; ++j) {
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
  for (int j = 0; j < k; ++j) {
    const float* p = pts + 3 * nb[j];
    const float x = __ldg(p) - mx, y = __ldg(p + 1) - my, z = __ldg(p + 2) - mz;
    c00 += x * x;
    c01 += x * y;
    c02 += x * z;
    c11 += y * y;
    c12 += y * z;
    c22 += z * z;
  }
  solve_and_flip(c00, c01, c02, c11, c12, c22, out + 3 * (first + t));
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int G, bool kSolver, bool kCloud>
__global__ void __launch_bounds__(32 * G) pca_lanes_kernel(
    const float* __restrict__ pts, const int64_t* __restrict__ idx, int n, int k,
    float* __restrict__ out) {
  extern __shared__ __align__(16) int64_t design_idx[];
  __shared__ float sums[kDesignPoints][6];
  constexpr int R = 32 / G;   // a lane's neighbours in registers
  const int t = threadIdx.x, p = t / G, l = t % G;
  const long long first = static_cast<long long>(blockIdx.x) * kDesignPoints;
  const int rows = n - first < kDesignPoints ? static_cast<int>(n - first) : kDesignPoints;
  const int count = rows * k;
  float* cloud = kCloud ? reinterpret_cast<float*>(design_idx + (kDesignPoints * k + 1) / 2 * 2)
                        : nullptr;
  stage(design_idx, idx + first * k, count, cloud, pts, n);
  const float* cl = kCloud ? cloud : pts;
  const bool valid = p < rows;
  const int64_t* nb = design_idx + (valid ? p : 0) * k;
  float px[R], py[R], pz[R];
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (valid) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = l + r * G;
      if (j < k) {
        const float* q = cl + 3 * nb[j];
        px[r] = kCloud ? q[0] : __ldg(q);
        py[r] = kCloud ? q[1] : __ldg(q + 1);
        pz[r] = kCloud ? q[2] : __ldg(q + 2);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (l + r * G < k) {
        sx += px[r];
        sy += py[r];
        sz += pz[r];
      }
    }
    for (int j = l + R * G; j < k; j += G) {
      const float* q = cl + 3 * nb[j];
      sx += kCloud ? q[0] : __ldg(q);
      sy += kCloud ? q[1] : __ldg(q + 1);
      sz += kCloud ? q[2] : __ldg(q + 2);
    }
  }
  const float fk = static_cast<float>(k);
  const float mx = group_sum<G>(sx) / fk, my = group_sum<G>(sy) / fk, mz = group_sum<G>(sz) / fk;
  float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f;
  if (valid) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (l + r * G < k) {
        const float x = px[r] - mx, y = py[r] - my, z = pz[r] - mz;
        c00 += x * x;
        c01 += x * y;
        c02 += x * z;
        c11 += y * y;
        c12 += y * z;
        c22 += z * z;
      }
    }
    for (int j = l + R * G; j < k; j += G) {
      const float* q = cl + 3 * nb[j];
      const float x = (kCloud ? q[0] : __ldg(q)) - mx, y = (kCloud ? q[1] : __ldg(q + 1)) - my,
                  z = (kCloud ? q[2] : __ldg(q + 2)) - mz;
      c00 += x * x;
      c01 += x * y;
      c02 += x * z;
      c11 += y * y;
      c12 += y * z;
      c22 += z * z;
    }
  }
  c00 = group_sum<G>(c00);
  c01 = group_sum<G>(c01);
  c02 = group_sum<G>(c02);
  c11 = group_sum<G>(c11);
  c12 = group_sum<G>(c12);
  c22 = group_sum<G>(c22);
  if (!kSolver) {
    if (!valid) return;
    float o[3];
    solve_and_flip(c00, c01, c02, c11, c12, c22, o);
    if (l == 0) {
      float* dst = out + 3 * (first + p);
      dst[0] = o[0];
      dst[1] = o[1];
      dst[2] = o[2];
    }
    return;
  }
  if (valid && l == 0) {
    sums[p][0] = c00;
    sums[p][1] = c01;
    sums[p][2] = c02;
    sums[p][3] = c11;
    sums[p][4] = c12;
    sums[p][5] = c22;
  }
  __syncthreads();
  if (t < rows)
    solve_and_flip(sums[t][0], sums[t][1], sums[t][2], sums[t][3], sums[t][4], sums[t][5],
                   out + 3 * (first + t));
}

template <typename K>
int launch_design(K kernel, int threads, size_t shared, const float* points, const int64_t* idx,
                  int n, int k, float* out, void* stream) {
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(n + kDesignPoints - 1) / kDesignPoints, threads, shared,
           static_cast<cudaStream_t>(stream)>>>(points, idx, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// design: 0 thread, 1 lanes<1>, 2 lanes<4>, 3 lanes<8>, 4 lanes<16>,
// 5 lanes<8> solver, 6 lanes<8> cloud.  points (n, 3) f32 and idx (n, k)
// int64, both 16-byte aligned -> out (n, 3) f32.  Outside any capture (the
// cloud design sets its shared memory limit at each launch).
extern "C" int pca_design_launch(int design, const float* points, const int64_t* idx, int n,
                                 int k, float* out, void* stream) {
  if (n <= 0 || k <= 0 || k > kPcaMaxK) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(idx) % 16 || reinterpret_cast<uintptr_t>(points) % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t rows = static_cast<size_t>((kDesignPoints * k + 1) / 2 * 2) * sizeof(int64_t);
  switch (design) {
    case 0: return launch_design(pca_thread_kernel, 32, rows, points, idx, n, k, out, stream);
    case 1: return launch_design(pca_lanes_kernel<1, false, false>, 32, rows, points, idx, n, k,
                                 out, stream);
    case 2: return launch_design(pca_lanes_kernel<4, false, false>, 128, rows, points, idx, n, k,
                                 out, stream);
    case 3: return launch_design(pca_lanes_kernel<8, false, false>, 256, rows, points, idx, n, k,
                                 out, stream);
    case 4: return launch_design(pca_lanes_kernel<16, false, false>, 512, rows, points, idx, n,
                                 k, out, stream);
    case 5: return launch_design(pca_lanes_kernel<8, true, false>, 256, rows, points, idx, n, k,
                                 out, stream);
    case 6: return launch_design(pca_lanes_kernel<8, false, true>, 256,
                                 rows + 12 * static_cast<size_t>(n), points, idx, n, k, out,
                                 stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
