// Fused window-BA factor pass (K1) for Hopper, sm_90a: one launch.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::window_factor_blocks (bodies _window_kernel / _window_kernel_single,
// both running _window_math and _stereo_math). For every observation slot
// m of the landmark-grouped [J, O] window layout (slot m belongs to
// landmark m / O) it gathers the slot's pose and landmark, evaluates the
// whitened stereo reprojection residual and its tangent Jacobians, and
// emits, into one output buffer, in this order:
//   u    [M, 18]  J_pose^T J_pt per slot      (pose-landmark coupling)
//   hll  [J, 9]   sum over the landmark's slots of J_pt^T J_pt
//   gl   [J, 3]   sum over the landmark's slots of J_pt^T r
//   hppgp[K, 43]  sum over the pose's slots of (J_pose^T J_pose | J_pose^T r
//                 | 0.5 |r|^2)
//   cost []       0.5 sum |r|^2 over all slots
// so that the window solver's blocks (Hpp, gp, Hll, U_jo, gl, the stereo
// cost) are views of it and nothing runs after the kernel.
//
// Inputs, fixed over a window (the plan, ops/window_kernel.py::make_plan,
// passed as one Args struct): obs [M, 16] per-slot records (uvd, the 3x3
// stiffness row-major, weight = valid & point valid, pose_free = 0 for a
// fixed pose, two zeros); pose_idx [M] int32, negative for padding slots;
// obs_by_pose [S, 16], the records of the S non-padding slots sorted by
// pose, with point_by_pose [S] their landmarks and pose_start [K + 1] (in
// the struct itself) the offsets of each pose's run; ticket, one unsigned
// zero between calls. Per call: poses [K, 12] ([t | R row-major]) and
// points [J, 3].
// The gauge mask (pose_free) zeroes J_pose but not the residual, so
// fixed-pose observations still add to the cost; padding slots add
// nothing. The depth is guarded (z == 0 -> 1) before 1/z: padding slots
// may carry arbitrary poses and 0 * inf = NaN would leak through the mask.
//
// What bounds it on an H100: at the flagship window (K = 2, M = 384) the
// pass moves ~60 KB in float64, far below a microsecond of HBM time, and
// does ~290k operations: the launch and one slot's dependent chain of
// arithmetic are the cost. At the S scale (K = 64, M = 16,384) it moves
// ~3 MB (~1 us) and does ~12 M operations (~0.4 us at 34 TFLOP/s float64).
//
// Design: one grid of 128-thread blocks of two kinds, K pose blocks then one
// block per run of whole landmarks of at most 64 slots (one landmark of up
// to 128). A block on one SM is bound by its float64 arithmetic (one slot
// is ~750 operations): small landmark blocks spread the landmark side over
// many SMs.
// - Pose block k walks the slots of pose k (obs_by_pose[pose_start[k] ..],
//   read directly: the offsets come with the launch's parameters, so a
//   slot costs two dependent loads, its record then its landmark), two
//   slots per thread per pass, both loaded before either is computed,
//   accumulates the pose side in registers (the 21 unique entries of the
//   symmetric Hpp, gp and the cost), reduces them in a fixed order through
//   shared memory (a warp-shuffle tree of 28 float64 values costs ~4x more
//   issue slots) and writes row k of hppgp. Work O(slots), with no scan
//   over the other poses' slots and no partials in global memory. The last
//   pose block to finish (an integer ticket, taken with acquire-release
//   order) sums the K per-pose costs in a fixed order into the cost scalar
//   and resets the ticket; one warp does this while the others reduce Hpp
//   and gp, so the ticket's round trip is off the block's critical path.
// - A landmark block stages the K poses in shared memory while its slots'
//   records and landmarks load, recomputes its slots (one thread each, ~750
//   operations, cheap beside a second launch), writes u per slot, stages
//   the 12 landmark-side values in shared memory and sums each landmark's
//   O slots in slot order (any O up to 128, ragged included).
// No floating-point atomics, so results are identical run to run; a
// single last block summing per-block partials would have to read 128 x
// 2,752 values at the S scale, slower than the two-pass design it replaces.
// The ticket makes concurrent calls with one plan on two streams unsafe;
// the solver issues them in order on one stream.
//
// Batched entry point (window_factor_blocks_batch_*): B windows of one
// shape (K, J, O) in one launch, for the independent chains that
// problems/batch_scan.py solves in lockstep. The grid is B * K pose blocks
// then B runs of landmark blocks; block i of window b runs the single-window
// code on window b's slice of the inputs and outputs, so window b's results
// equal a single-window launch on the same window bit for bit. What changes:
// the pose offsets come from a device array (pose_start [B, K + 1], into the
// concatenated by-pose records), each window has its own ticket and its own
// camera (cams [B, 5], double: fu, fv, cu, cv, fu * b), and the outputs are
// stacked by kind: u [B, M, 18], hll [B, J, 9], gl [B, J, 3],
// hppgp [B, K, 43], cost [B].

#include <cuda/atomic>
#include <cuda_runtime.h>

constexpr int kWindowMaxPoses = 128;  // ops/window_kernel.py::MAX_POSES

// The plan of one window (mirrors ops/window_kernel.py::_Args). Outside the
// anonymous namespace: the extern "C" entry points take it, and would not be
// exported otherwise.
struct Args {
  const void* obs;
  const void* obs_by_pose;
  const int* pose_idx;
  const int* point_by_pose;
  unsigned int* ticket;
  double fu, fv, cu, cv, fb;
  int K, J, O, device;
  int multi_device;  // more than one device visible: launch on `device`
  int pose_start[kWindowMaxPoses + 1];
};

// The plan of B windows (mirrors ops/window_kernel.py::_BatchArgs).
struct BatchArgs {
  const void* obs;            // [B * M, 16]
  const void* obs_by_pose;    // [S, 16], every window's by-pose records in turn
  const int* pose_idx;        // [B * M]
  const int* point_by_pose;   // [S]: the slot's landmark within its window
  const int* pose_start;      // [B, K + 1]: offsets into obs_by_pose
  unsigned int* ticket;       // [B]
  const double* cams;         // [B, 5]
  int B, K, J, O, device;
  int multi_device;
};

namespace {

constexpr int kThreads = 128;       // also the most slots one landmark may have
constexpr int kLmSlots = 64;        // slots of a landmark block (whole landmarks, O <= 64)
constexpr int kRows = 43;           // hppgp row: 36 Hpp + 6 gp + 1 cost
constexpr int kRed = 28;            // reduced per pose: 21 Hpp (upper) + 6 gp + 1 cost
constexpr int kParts = 16;          // the pose reduction's first level: 16 partial sums a value
constexpr int kLmRows = 12;         // per landmark: 9 Hll + 3 gl
constexpr int kRec = 16;            // obs record width
constexpr int kPitch = kThreads + 1;  // +1: a row's sums read along it, off one bank
constexpr int kSmem = (kRed * kPitch > kLmRows * kPitch + 12 * kWindowMaxPoses)
                          ? kRed * kPitch : kLmRows * kPitch + 12 * kWindowMaxPoses;
constexpr unsigned kFull = 0xffffffffu;

// the 14 used values of one obs record: four 16-byte loads (float), seven (double)
__device__ __forceinline__ void load_obs(const float* r, float v[16]) {
  const float4* q = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = __ldg(q + i);
    v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
  }
}
__device__ __forceinline__ void load_obs(const double* r, double v[16]) {
  const double2* q = reinterpret_cast<const double2*>(r);
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    const double2 t = __ldg(q + i);
    v[2 * i] = t.x; v[2 * i + 1] = t.y;
  }
}

template <typename T>
struct Cam {
  T fu, fv, cu, cv, fb;
};

// One slot's whitened, masked residual rw and pose Jacobian Jw_pose (and,
// with kPoint, its landmark Jacobian Jw_pt). P: the slot's pose (global or
// shared memory); p: its landmark; v: its obs record.
template <typename T, bool kPoint>
__device__ __forceinline__ void factor(const Cam<T>& cam, const T* P, const T p[3],
                                       const T v[16], T rw[3], T Jw_pose[3][6],
                                       T Jw_pt[3][3]) {
  T R[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) R[a][b] = P[3 + 3 * a + b];
  T pc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) pc[a] = R[a][0] * p[0] + R[a][1] * p[1] + R[a][2] * p[2] + P[a];

  const T z = (pc[2] == T(0)) ? T(1) : pc[2];
  const T iz = T(1) / z;
  const T iz2 = iz * iz;
  const T res[3] = {cam.fu * pc[0] * iz + cam.cu - v[0], cam.fv * pc[1] * iz + cam.cv - v[1],
                    cam.fb * iz - v[2]};
  const T Jproj[3][3] = {{cam.fu * iz, T(0), -cam.fu * pc[0] * iz2},
                         {T(0), cam.fv * iz, -cam.fv * pc[1] * iz2},
                         {T(0), T(0), -cam.fb * iz2}};
  // d p_c / d eps = [I | -p_c^] (left perturbation)
  const T Jpc[3][6] = {{T(1), T(0), T(0), T(0), pc[2], -pc[1]},
                       {T(0), T(1), T(0), -pc[2], T(0), pc[0]},
                       {T(0), T(0), T(1), pc[1], -pc[0], T(0)}};
  T Jpose[3][6], Jpt[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Jpose[a][j] = Jproj[a][0] * Jpc[0][j] + Jproj[a][1] * Jpc[1][j] + Jproj[a][2] * Jpc[2][j];
    if constexpr (kPoint) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Jpt[a][j] = Jproj[a][0] * R[0][j] + Jproj[a][1] * R[1][j] + Jproj[a][2] * R[2][j];
    }
  }

  // whiten by the stiffness, mask by validity (and the gauge on J_pose)
  const T w = v[12];
  const T wp = w * v[13];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T s0 = v[3 + 3 * a], s1 = v[4 + 3 * a], s2 = v[5 + 3 * a];
    rw[a] = w * (s0 * res[0] + s1 * res[1] + s2 * res[2]);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Jw_pose[a][j] = wp * (s0 * Jpose[0][j] + s1 * Jpose[1][j] + s2 * Jpose[2][j]);
    if constexpr (kPoint) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Jw_pt[a][j] = w * (s0 * Jpt[0][j] + s1 * Jpt[1][j] + s2 * Jpt[2][j]);
    }
  }
}

// index of Hpp entry (a, b) among the 21 of the upper triangle
__host__ __device__ constexpr int tri(int a, int b) { return a * 6 - a * (a - 1) / 2 + (b - a); }

template <typename T>
__device__ __forceinline__ void accumulate(const T Jp[3][6], const T rw[3], T acc[kRed]) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b)
      acc[tri(a, b)] += Jp[0][a] * Jp[0][b] + Jp[1][a] * Jp[1][b] + Jp[2][a] * Jp[2][b];
    acc[21 + a] += Jp[0][a] * rw[0] + Jp[1][a] * rw[1] + Jp[2][a] * rw[2];
  }
  acc[27] += T(0.5) * (rw[0] * rw[0] + rw[1] * rw[1] + rw[2] * rw[2]);
}

// One window of a launch: its inputs and outputs (every pointer at the
// window's own slice; obs_by_pose and point_by_pose are indexed by the
// pose offsets the caller passes).
template <typename T>
struct Window {
  const T* obs;            // [M, 16]
  const T* obs_by_pose;    // [S, 16]
  const int* pose_idx;     // [M]
  const int* point_by_pose;  // [S]
  unsigned int* ticket;
  const T* poses;          // [K, 12]
  const T* points;         // [J, 3]
  T* u;                    // [M, 18]
  T* hll;                  // [J, 9]
  T* gl;                   // [J, 3]
  T* hppgp;                // [K, 43]
  T* cost;                 // []
  int K, J, O;
};

// pose k of window w, whose slots are obs_by_pose[s0 .. s1)
template <typename T>
__device__ __forceinline__ void pose_block(const Window<T>& w, const Cam<T>& cam, int k, int s0,
                                           int s1, T* red, T* part) {
  const int tid = threadIdx.x;
  const T* obs = w.obs_by_pose;
  const T* __restrict__ points = w.points;
  T* __restrict__ hppgp = w.hppgp;
  const T* P = w.poses + 12 * k;
  T acc[kRed];
#pragma unroll
  for (int r = 0; r < kRed; ++r) acc[r] = T(0);
  // two slots per thread per pass, both loaded before either is computed
  for (int s = s0 + tid; s < s1; s += 2 * kThreads) {
    const int s2 = s + kThreads;
    const bool two = s2 < s1;
    T va[16], vb[16], rw[3], Jp[3][6], Jl[3][3];
    load_obs(obs + static_cast<size_t>(s) * kRec, va);
    const T* pa = points + 3 * w.point_by_pose[s];
    const T* pb = points + 3 * w.point_by_pose[two ? s2 : s];
    if (two) load_obs(obs + static_cast<size_t>(s2) * kRec, vb);
    const T a3[3] = {__ldg(pa), __ldg(pa + 1), __ldg(pa + 2)};
    const T b3[3] = {__ldg(pb), __ldg(pb + 1), __ldg(pb + 2)};
    factor<T, false>(cam, P, a3, va, rw, Jp, Jl);
    accumulate(Jp, rw, acc);
    if (two) {
      factor<T, false>(cam, P, b3, vb, rw, Jp, Jl);
      accumulate(Jp, rw, acc);
    }
  }

  // Fixed-order reductions through shared memory. The last warp takes the
  // pose's cost first (each lane 4 threads' values, then a shuffle tree),
  // publishes it and takes the ticket while the other three warps reduce
  // the 27 Hpp/gp values (partial q of a value sums threads q, q + 16, ...,
  // q + 112, 16 lanes on 16 distinct bank pairs; then the 16 partials in
  // order) behind a barrier of their own.
#pragma unroll
  for (int r = 0; r < kRed; ++r) red[r * kPitch + tid] = acc[r];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  if (warp == kThreads / 32 - 1) {
    const T* row = red + (kRed - 1) * kPitch + lane;
    T x = row[0] + row[32] + row[64] + row[96];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
    // The last pose block to finish sums the K per-pose costs. Lane 0's
    // acquire-release increment of the ticket publishes this pose's cost
    // and, in the last block, orders the loads of the others' after theirs.
    unsigned prev = 0u;
    if (lane == 0) {
      hppgp[k * kRows + kRows - 1] = x;
      cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*w.ticket);
      prev = ticket.fetch_add(1u, cuda::memory_order_acq_rel);
    }
    const bool last = __shfl_sync(kFull, prev, 0) == static_cast<unsigned>(w.K - 1);
    __syncwarp();
    if (last) {
      T c[kWindowMaxPoses / 32];
#pragma unroll
      for (int i = 0; i < kWindowMaxPoses / 32; ++i) {
        const int kk = lane + 32 * i;
        c[i] = kk < w.K ? __ldcg(hppgp + kk * kRows + kRows - 1) : T(0);
      }
      T y = c[0];
#pragma unroll
      for (int i = 1; i < kWindowMaxPoses / 32; ++i) y += c[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) y += __shfl_down_sync(kFull, y, off);
      if (lane == 0) {
        *w.cost = y;
        *w.ticket = 0u;
      }
    }
    return;
  }
  constexpr int kWorkers = kThreads - 32;
  for (int item = tid; item < (kRed - 1) * kParts; item += kWorkers) {
    const T* row = red + (item / kParts) * kPitch + item % kParts;
    T x = T(0);
#pragma unroll
    for (int i = 0; i < kThreads / kParts; ++i) x += row[kParts * i];
    part[item] = x;
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kWorkers));
  if (tid < kRows - 1) {
    int i;
    if (tid < 36) {
      const int a = tid / 6, b = tid - 6 * (tid / 6);
      i = a <= b ? tri(a, b) : tri(b, a);
    } else {
      i = 21 + (tid - 36);
    }
    T x = T(0);
#pragma unroll
    for (int q = 0; q < kParts; ++q) x += part[i * kParts + q];
    hppgp[k * kRows + tid] = x;
  }
}

// landmark block b of window w
template <typename T>
__device__ __forceinline__ void landmark_block(const Window<T>& w, const Cam<T>& cam, int b,
                                               T* stage, T* pose_s) {
  const T* __restrict__ poses = w.poses;
  const T* __restrict__ points = w.points;
  T* __restrict__ u = w.u;
  T* __restrict__ hll = w.hll;
  T* __restrict__ gl = w.gl;
  const int tid = threadIdx.x, O = w.O, L = O <= kLmSlots ? kLmSlots / O : 1;
  const int j0 = b * L;
  const int nl = min(L, w.J - j0);
  const int m = j0 * O + tid;
  const bool on = tid < nl * O;
  // the slot's loads first, then the poses into shared memory, one barrier
  int k = -1;
  T v[16], p[3];
  if (on) {
    k = w.pose_idx[m];
    load_obs(w.obs + static_cast<size_t>(m) * kRec, v);
    const T* pt = points + 3 * (j0 + tid / O);
    p[0] = __ldg(pt); p[1] = __ldg(pt + 1); p[2] = __ldg(pt + 2);
  }
  for (int i = tid; i < 12 * w.K; i += kThreads) pose_s[i] = __ldg(poses + i);
  __syncthreads();

  T h[kLmRows];
#pragma unroll
  for (int r = 0; r < kLmRows; ++r) h[r] = T(0);
  if (on) {
    T* um = u + static_cast<size_t>(m) * 18;
    if (k >= 0) {
      T rw[3], Jp[3][6], Jl[3][3];
      factor<T, true>(cam, pose_s + 12 * k, p, v, rw, Jp, Jl);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          h[3 * a + c] = Jl[0][a] * Jl[0][c] + Jl[1][a] * Jl[1][c] + Jl[2][a] * Jl[2][c];
        h[9 + a] = Jl[0][a] * rw[0] + Jl[1][a] * rw[1] + Jl[2][a] * rw[2];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          um[3 * a + c] = Jp[0][a] * Jl[0][c] + Jp[1][a] * Jl[1][c] + Jp[2][a] * Jl[2][c];
    } else {
#pragma unroll
      for (int r = 0; r < 18; ++r) um[r] = T(0);
    }
  }
  // stage, then sum each landmark's O slots in slot order
#pragma unroll
  for (int r = 0; r < kLmRows; ++r) stage[r * kPitch + tid] = h[r];
  __syncthreads();
  for (int item = tid; item < nl * kLmRows; item += kThreads) {
    const int l = item / kLmRows, r = item - l * kLmRows;
    const T* row = stage + r * kPitch + l * O;
    T x = T(0);
    for (int o = 0; o < O; ++o) x += row[o];
    const int j = j0 + l;
    if (r < 9) {
      hll[j * 9 + r] = x;
    } else {
      gl[j * 3 + (r - 9)] = x;
    }
  }
}

// landmark blocks of a window: runs of whole landmarks of at most kLmSlots slots
__host__ __device__ inline int landmark_blocks(int J, int O) {
  const int L = O <= kLmSlots ? kLmSlots / O : 1;
  return (J + L - 1) / L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) window_factor_kernel(
    const Args g, const T* __restrict__ poses, const T* __restrict__ points,
    T* __restrict__ out) {
  __shared__ __align__(16) T smem[kSmem];
  __shared__ T part[(kRed - 1) * kParts];
  const Cam<T> cam{T(g.fu), T(g.fv), T(g.cu), T(g.cv), T(g.fb)};
  const size_t M = static_cast<size_t>(g.J) * g.O;
  T* u = out;
  T* hll = u + M * 18;
  T* gl = hll + static_cast<size_t>(g.J) * 9;
  T* hppgp = gl + static_cast<size_t>(g.J) * 3;
  const Window<T> w{static_cast<const T*>(g.obs), static_cast<const T*>(g.obs_by_pose),
                    g.pose_idx, g.point_by_pose, g.ticket, poses, points, u, hll, gl, hppgp,
                    hppgp + static_cast<size_t>(g.K) * kRows, g.K, g.J, g.O};
  const int k = blockIdx.x;
  if (k < g.K) {
    pose_block<T>(w, cam, k, g.pose_start[k], g.pose_start[k + 1], smem, part);
  } else {
    landmark_block<T>(w, cam, k - g.K, smem, smem + kLmRows * kPitch);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) window_factor_batch_kernel(
    const BatchArgs g, const T* __restrict__ poses, const T* __restrict__ points,
    T* __restrict__ out) {
  __shared__ __align__(16) T smem[kSmem];
  __shared__ T part[(kRed - 1) * kParts];
  const int K = g.K, J = g.J, O = g.O;
  const int nlb = landmark_blocks(J, O);
  const int i = blockIdx.x;
  const bool pose = i < g.B * K;
  const int b = pose ? i / K : (i - g.B * K) / nlb;
  const size_t M = static_cast<size_t>(J) * O, B = g.B;
  T* u = out;
  T* hll = u + B * M * 18;
  T* gl = hll + B * J * 9;
  T* hppgp = gl + B * J * 3;
  T* cost = hppgp + B * K * kRows;
  const double* c = g.cams + 5 * b;
  const Cam<T> cam{T(c[0]), T(c[1]), T(c[2]), T(c[3]), T(c[4])};
  const Window<T> w{static_cast<const T*>(g.obs) + b * M * kRec,
                    static_cast<const T*>(g.obs_by_pose), g.pose_idx + b * M, g.point_by_pose,
                    g.ticket + b, poses + static_cast<size_t>(b) * K * 12,
                    points + static_cast<size_t>(b) * J * 3, u + b * M * 18,
                    hll + static_cast<size_t>(b) * J * 9, gl + static_cast<size_t>(b) * J * 3,
                    hppgp + static_cast<size_t>(b) * K * kRows, cost + b, K, J, O};
  if (pose) {
    const int k = i - b * K;
    const int* start = g.pose_start + b * (K + 1) + k;
    pose_block<T>(w, cam, k, __ldg(start), __ldg(start + 1), smem, part);
  } else {
    landmark_block<T>(w, cam, i - g.B * K - b * nlb, smem, smem + kLmRows * kPitch);
  }
}

template <typename T>
int launch(const Args* g, const T* poses, const T* points, T* out, void* stream) {
  if (g->K < 1 || g->K > kWindowMaxPoses || g->J < 1 || g->O < 1 || g->O > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = g->device;
  if (g->multi_device) cudaGetDevice(&current);
  if (current != g->device) cudaSetDevice(g->device);
  window_factor_kernel<T><<<g->K + landmark_blocks(g->J, g->O), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(*g, poses, points, out);
  const cudaError_t err = cudaGetLastError();
  if (current != g->device) cudaSetDevice(current);
  return static_cast<int>(err);
}

template <typename T>
int launch_batch(const BatchArgs* g, const T* poses, const T* points, T* out, void* stream) {
  if (g->B < 1 || g->K < 1 || g->K > kWindowMaxPoses || g->J < 1 || g->O < 1 ||
      g->O > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(g->B) * (g->K + landmark_blocks(g->J, g->O));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int current = g->device;
  if (g->multi_device) cudaGetDevice(&current);
  if (current != g->device) cudaSetDevice(g->device);
  window_factor_batch_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(*g, poses, points, out);
  const cudaError_t err = cudaGetLastError();
  if (current != g->device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int window_factor_blocks_f32(const Args* g, const float* poses, const float* points, float* out,
                             void* stream) {
  return launch<float>(g, poses, points, out, stream);
}

int window_factor_blocks_f64(const Args* g, const double* poses, const double* points,
                             double* out, void* stream) {
  return launch<double>(g, poses, points, out, stream);
}

int window_factor_blocks_batch_f32(const BatchArgs* g, const float* poses, const float* points,
                                   float* out, void* stream) {
  return launch_batch<float>(g, poses, points, out, stream);
}

int window_factor_blocks_batch_f64(const BatchArgs* g, const double* poses,
                                   const double* points, double* out, void* stream) {
  return launch_batch<double>(g, poses, points, out, stream);
}

}  // extern "C"
