// The registration epoch's update for Hopper (sm_90a), fp32: everything an
// epoch does after its loss and gradient, in one launch.
//
//   epoch_update_kernel <- autourdf_tpu/registration/optimizer.py adam_update,
//                          plateau_update and the rest of _epoch_step (best
//                          tracking, the early-stop freeze)
//
// It replaces no Pallas kernel: XLA fused these into the JAX package's
// epoch program.  In PyTorch they were some fifty small kernels an epoch,
// plus the assembly of the flat gradient (a zero-filled (S, P) tensor a
// parameter, copied into and added), about 670 MB of traffic and 79 graph
// nodes at the benchmark's (S, P) = (5, 425,991).
//
// Bound by bytes: a parameter reads its gradient, theta, mu and nu and
// writes theta, mu and nu, 28 bytes (59.6 MB, 17.8 us at 3.35 TB/s at that
// shape); the (S,) and (S, K, 4, 4) bookkeeping is noise beside it.  The
// design moves those bytes once:
//   - The gradient comes as autograd made it, one tensor a parameter (the
//     GEMMs' and the bias sums' outputs): a table of at most 16 segments,
//     each its pointer and the columns [offset, offset + n) of theta's rows
//     it covers, passed by value; each block copies it to shared memory.
//   - A block owns 2,048 columns of one sequence's row (blockIdx.y), 8 a
//     thread, neighbouring threads on neighbouring columns (coalesced 4-byte
//     accesses).  A row is P floats and P is odd, and the segments start at
//     arbitrary columns, so no 16-byte access would be aligned in all four
//     arrays at once; each thread starts its 32 loads before any arithmetic
//     instead, enough bytes in flight to stream at the card's rate.
//   - Every block computes its sequence's decisions from the old (S,)
//     inputs (frozen, the learning rate, the bias corrections of step + 1);
//     block 0 of a sequence alone writes its (S,) and (S, K, 4, 4) outputs.
//     Outputs never alias inputs, so no block reads what another writes.
// The arithmetic is the plain chain's (registration/optimizer.py
// _epoch_update_plain), operation by operation and in its order, rounded
// as PyTorch's kernels round it: -fmad=false keeps every multiply and add
// apart, division and square root are IEEE, the bias corrections are
// 1 - powf(b, t) as torch.pow computes them, and the constants are the
// float32 values PyTorch makes of its Python scalars (the wrapper's).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegments = 16;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kBlockColumns = kThreads * kItems;

struct EpochUpdateArgs {
  const float* grad[kMaxSegments];    // segment i: (S, offset[i + 1] - offset[i])
  int offset[kMaxSegments + 1];       // unused entries hold P
  const float *theta, *mu, *nu;       // (S, P)
  const int* step;                    // (S,)
  const float *sched_best, *lr;       // (S,)
  const int* num_bad;                 // (S,)
  const float *best_loss, *best_m, *m2, *loss;   // (S,), (S, K, 4, 4) twice, (S,)
  const int* bad_count;               // (S,)
  const bool* stopped;                // (S,)
  float *theta_o, *mu_o, *nu_o;
  int* step_o;
  float *sched_best_o, *lr_o;
  int* num_bad_o;
  float *best_loss_o, *best_m_o;
  int* bad_count_o;
  bool* stopped_o;
  float* loss_o;                      // inf where frozen
  int P, pose_floats;
  float b1, c1, b2, c2, eps;          // Adam: b1, 1 - b1, b2, 1 - b2, eps
  float threshold_factor, factor;     // plateau: 1 - threshold, the cut
  int stop_patience, patience;
};

__global__ void __launch_bounds__(kThreads) epoch_update_kernel(const EpochUpdateArgs a) {
  __shared__ const float* seg_grad[kMaxSegments];
  __shared__ int seg_off[kMaxSegments + 1];
  // static indices into the parameter struct (a dynamic index would copy
  // it to local memory)
#pragma unroll
  for (int i = 0; i < kMaxSegments; ++i)
    if (threadIdx.x == i) seg_grad[i] = a.grad[i];
#pragma unroll
  for (int i = 0; i <= kMaxSegments; ++i)
    if (threadIdx.x == i) seg_off[i] = a.offset[i];
  __syncthreads();

  const int s = blockIdx.y;
  const bool frozen = a.stopped[s];
  const long long row = static_cast<long long>(s) * a.P;
  const int first = blockIdx.x * kBlockColumns + threadIdx.x;

  if (frozen) {
    // the carry passes through (the reference's loop break)
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = first + k * kThreads;
      if (j < a.P) {
        a.theta_o[row + j] = a.theta[row + j];
        a.mu_o[row + j] = a.mu[row + j];
        a.nu_o[row + j] = a.nu[row + j];
      }
    }
  } else {
    // Adam with the current lr (the plateau's cut takes effect next epoch)
    const float lr = a.lr[s];
    const float t = static_cast<float>(a.step[s] + 1);
    const float bc1 = 1.0f - powf(a.b1, t);
    const float bc2 = 1.0f - powf(a.b2, t);
    int seg = 0;
    while (seg + 1 < kMaxSegments && first >= seg_off[seg + 1]) ++seg;
    float g[kItems], th[kItems], m[kItems], v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = first + k * kThreads;
      if (j < a.P) {
        while (j >= seg_off[seg + 1]) ++seg;
        const int n = seg_off[seg + 1] - seg_off[seg];
        g[k] = seg_grad[seg][static_cast<long long>(s) * n + (j - seg_off[seg])];
        th[k] = a.theta[row + j];
        m[k] = a.mu[row + j];
        v[k] = a.nu[row + j];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = first + k * kThreads;
      if (j < a.P) {
        const float mu = a.b1 * m[k] + a.c1 * g[k];
        const float nu = a.b2 * v[k] + (a.c2 * g[k]) * g[k];
        a.mu_o[row + j] = mu;
        a.nu_o[row + j] = nu;
        a.theta_o[row + j] = th[k] - (lr * (mu / bc1)) / (sqrtf(nu / bc2) + a.eps);
      }
    }
  }

  if (blockIdx.x != 0) return;
  // block 0 of the sequence: best tracking, early stop, the plateau step
  const float loss = a.loss[s];
  const bool improved = loss < a.best_loss[s];
  const long long pose = static_cast<long long>(s) * a.pose_floats;
  for (int e = threadIdx.x; e < a.pose_floats; e += kThreads)
    a.best_m_o[pose + e] = (improved && !frozen) ? a.m2[pose + e] : a.best_m[pose + e];
  if (threadIdx.x != 0) return;
  const int bad = improved ? 0 : a.bad_count[s] + 1;
  const bool stop_now = bad > a.stop_patience;
  const float sched_best = a.sched_best[s];
  const bool better = loss < sched_best * a.threshold_factor;
  int num_bad = better ? 0 : a.num_bad[s] + 1;
  const bool cut = num_bad > a.patience;
  const float lr = a.lr[s];
  if (cut) num_bad = 0;
  a.step_o[s] = frozen ? a.step[s] : a.step[s] + 1;
  a.sched_best_o[s] = (better && !frozen) ? loss : sched_best;
  a.num_bad_o[s] = frozen ? a.num_bad[s] : num_bad;
  a.lr_o[s] = (cut && !frozen) ? lr * a.factor : lr;
  a.best_loss_o[s] = (improved && !frozen) ? loss : a.best_loss[s];
  a.bad_count_o[s] = frozen ? a.bad_count[s] : bad;
  a.stopped_o[s] = frozen || stop_now;
  a.loss_o[s] = frozen ? __int_as_float(0x7f800000) : loss;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes, ops/_cuda.py); returns the launch's cudaError_t
// ---------------------------------------------------------------------------

// One epoch's update of S sequences of P parameters: grads[i] (S, n_i)
// covers the columns [offsets[i], offsets[i + 1]) of a row, the segments in
// order and tiling [0, P); in_ and out_ are the carry's tensors in the order
// of EpochUpdateArgs (theta, mu, nu, step, sched_best, lr, num_bad,
// best_loss, best_m, m2, loss, bad_count, stopped; the outputs without m2
// and with the masked loss last); pose_floats = K * 16.
extern "C" int optim_epoch_update_launch(const void* const* grads, const int* offsets,
                                         int segments, const void* const* in_, void* const* out_,
                                         int S, int P, int pose_floats, float b1, float c1,
                                         float b2, float c2, float eps, float threshold_factor,
                                         float factor, int stop_patience, int patience,
                                         void* stream) {
  if (segments < 1 || segments > kMaxSegments || S < 1 || S > 65535 || P < 1 ||
      pose_floats < 0 || offsets[0] != 0 || offsets[segments] != P)
    return (int)cudaErrorInvalidValue;
  EpochUpdateArgs a{};
  for (int i = 0; i < kMaxSegments; ++i) {
    a.grad[i] = i < segments ? static_cast<const float*>(grads[i]) : nullptr;
    a.offset[i] = i < segments ? offsets[i] : P;
    if (i < segments && offsets[i + 1] <= offsets[i]) return (int)cudaErrorInvalidValue;
  }
  a.offset[kMaxSegments] = P;
  a.theta = static_cast<const float*>(in_[0]);
  a.mu = static_cast<const float*>(in_[1]);
  a.nu = static_cast<const float*>(in_[2]);
  a.step = static_cast<const int*>(in_[3]);
  a.sched_best = static_cast<const float*>(in_[4]);
  a.lr = static_cast<const float*>(in_[5]);
  a.num_bad = static_cast<const int*>(in_[6]);
  a.best_loss = static_cast<const float*>(in_[7]);
  a.best_m = static_cast<const float*>(in_[8]);
  a.m2 = static_cast<const float*>(in_[9]);
  a.loss = static_cast<const float*>(in_[10]);
  a.bad_count = static_cast<const int*>(in_[11]);
  a.stopped = static_cast<const bool*>(in_[12]);
  a.theta_o = static_cast<float*>(out_[0]);
  a.mu_o = static_cast<float*>(out_[1]);
  a.nu_o = static_cast<float*>(out_[2]);
  a.step_o = static_cast<int*>(out_[3]);
  a.sched_best_o = static_cast<float*>(out_[4]);
  a.lr_o = static_cast<float*>(out_[5]);
  a.num_bad_o = static_cast<int*>(out_[6]);
  a.best_loss_o = static_cast<float*>(out_[7]);
  a.best_m_o = static_cast<float*>(out_[8]);
  a.bad_count_o = static_cast<int*>(out_[9]);
  a.stopped_o = static_cast<bool*>(out_[10]);
  a.loss_o = static_cast<float*>(out_[11]);
  a.P = P;
  a.pose_floats = pose_floats;
  a.b1 = b1;
  a.c1 = c1;
  a.b2 = b2;
  a.c2 = c2;
  a.eps = eps;
  a.threshold_factor = threshold_factor;
  a.factor = factor;
  a.stop_patience = stop_patience;
  a.patience = patience;
  const dim3 grid((P + kBlockColumns - 1) / kBlockColumns, S);
  epoch_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
