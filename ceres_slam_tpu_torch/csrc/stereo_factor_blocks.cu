// Stereo factor blocks with their pose and landmark sums (K2) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::stereo_factor_blocks (body _stereo_kernel, math _stereo_math) together
// with the gather-table sums its caller runs right after it
// (ceres_slam_tpu/solver/pcg.py::build_obs_blocks): the factor pass of the
// full-batch Schur-PCG assembly. For every observation n, from its pose
// T[pose(n)] ([t | R row-major]), landmark p[point(n)], measurement uvd[n]
// and 3x3 stiffness S[n], it evaluates the whitened stereo residual
// r = S (project(R p + t) - uvd) with the tangent Jacobians
// J_pose = S Jproj [I | -p_c^] and J_pt = S Jproj R, and writes into one
// output buffer, in this order:
//   U18 [N, 18]  J_pose^T J_pt per observation, zero where the observation
//                is masked or its pose gauge-fixed
//   Hpp [K, 36]  sum over the pose's observations of J_pose^T J_pose
//   gp  [K, 6]   sum of J_pose^T r                 (both zero for a fixed pose)
//   Hll [J, 9]   sum over the landmark's observations of J_pt^T J_pt
//   gl  [J, 3]   sum of J_pt^T r                   (both zero for an invalid landmark)
// A masked observation (invalid, or its landmark invalid) is skipped: it
// adds exact zeros whatever its landmark holds, so no safe point is needed.
// The depth is guarded (z == 0 -> 1) before 1/z as in the plain version.
//
// Inputs fixed over a solve come from the full-batch plan
// (ops/full_batch_plan.py, one Plan struct): the pose segments (ps_start,
// ps_obs, ps_point, ps_valid; ps_contig marks a pose whose observation ids
// are consecutive), the records rec [N, 12] (uvd | stiffness) in pose-slot
// order, the landmark segments (pt_start, and pt_q, each landmark slot's
// position in the pose slots), the masks and the scratch hg [N, 12]. Per
// call: poses [K, 12] and points [J, 3].
//
// What bounds it on an H100: memory. The function reads uvd, the stiffness,
// one pose and one landmark index and a validity flag per observation and
// the state, and writes U18 and the four sums: 33.5 MB at kitti1100 full
// batch (N = 124,480) in float64, 10.0 us at 3.35 TB/s; ~650 float64
// operations an observation (~2.4 us at 34 TFLOP/s). This design also
// writes and reads the per-slot Hll | gl scratch (12 MB each way in
// float64) and reads each record as 96 bytes (uvd, stiffness). The PR 2 form wrote 75
// values an observation as rows 24-288 bytes apart (every warp store touched
// up to 32 lines), and four gather sums after it read them again.
//
// Design:
// - Pose kernel: a 128-thread block per pose over its pose segment, one
//   slot a thread per pass. The pose is uniform in the block and is read
//   once; the records are read in pose-slot order (16-byte loads), the
//   landmark by index (points stay in L2). Each thread keeps the 21 unique
//   Hpp entries and gp in registers; the block sums them in a fixed order
//   through shared memory (16 partials of 8 threads, then the 16 in order).
//   U18 rows and the per-slot Hll | gl go through shared memory: the block
//   writes U18's span with 16-byte stores when the pose's observation ids
//   are consecutive (every pose of a dataset but the one holding the
//   padding tail) and row by row otherwise, and hg's span (always
//   contiguous) with 16-byte stores.
// - Landmark kernel: a thread per landmark and value (12 a landmark) sums
//   hg over the landmark's segment in slot order, loading 16 slots'
//   positions, then their values, at a time (a landmark has up to ~36
//   slots: one dependent load pair per slot would make the longest
//   landmark the kernel's time). A programmatic dependent launch of it
//   (loading its bounds while the pose kernel drains) measured no faster
//   than two plain launches on the H100 (PERF.md), and is not used.
// No atomics: the result is identical run to run. No tensor cores, no TF32.

#include <cuda_runtime.h>

#include "full_batch_plan.h"

namespace {

constexpr int kThreads = 128;    // pose kernel
constexpr int kLmThreads = 256;  // landmark kernel
constexpr int kRed = 27;         // reduced per pose: 21 Hpp (upper) + 6 gp
constexpr int kParts = 16;       // first level of the pose reduction: 16 partials a value
constexpr int kPitch = kThreads + 1;
constexpr int kRec = 12;         // record: uvd | stiffness
constexpr int kLm = 12;          // per slot and landmark: 9 Hll + 3 gl
constexpr int kBatch = 16;       // landmark kernel: slots loaded together
constexpr int kUStage = kThreads * 18 + 4;  // +4: room to align the stage with U18's words
constexpr int kStage = kUStage + kThreads * kLm;
constexpr int kSmem = kStage > kRed * kPitch ? kStage : kRed * kPitch;

template <typename T>
struct Pair;  // two values of T
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T>
struct Word;  // the 16-byte word of T
template <>
struct Word<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Word<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ void load_rec(const T* r, T v[kRec]) {
  using W = typename Word<T>::type;
  constexpr int n = Word<T>::n;
  const W* q = reinterpret_cast<const W*>(r);
#pragma unroll
  for (int i = 0; i < kRec / n; ++i) {
    const W t = __ldg(q + i);
    const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
    for (int c = 0; c < n; ++c) v[n * i + c] = e[c];
  }
}

template <typename T>
struct Cam {
  T fu, fv, cu, cv, fb;
};

// One observation's whitened residual rw and Jacobians Jw_pose, Jw_pt. P:
// the pose (shared memory); p: the landmark; v: the record.
template <typename T>
__device__ __forceinline__ void factor(const Cam<T>& cam, const T* P, const T p[3],
                                       const T v[kRec], T rw[3], T Jw_pose[3][6],
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
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jpt[a][j] = Jproj[a][0] * R[0][j] + Jproj[a][1] * R[1][j] + Jproj[a][2] * R[2][j];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T s0 = v[3 + 3 * a], s1 = v[4 + 3 * a], s2 = v[5 + 3 * a];
    rw[a] = s0 * res[0] + s1 * res[1] + s2 * res[2];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Jw_pose[a][j] = s0 * Jpose[0][j] + s1 * Jpose[1][j] + s2 * Jpose[2][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) Jw_pt[a][j] = s0 * Jpt[0][j] + s1 * Jpt[1][j] + s2 * Jpt[2][j];
  }
}

// index of Hpp entry (a, b) among the 21 of the upper triangle
__host__ __device__ constexpr int tri(int a, int b) { return a * 6 - a * (a - 1) / 2 + (b - a); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) pose_kernel(const Plan g,
                                                            const T* __restrict__ poses,
                                                            const T* __restrict__ points,
                                                            T* __restrict__ out) {
  __shared__ __align__(16) T smem[kSmem];
  __shared__ T part[kRed * kParts];
  __shared__ T pose_s[12];
  __shared__ int obs_s[kThreads];
  using W = typename Word<T>::type;
  using P = typename Pair<T>::type;
  constexpr int V = Word<T>::n;
  const int k = blockIdx.x, tid = threadIdx.x;
  const Cam<T> cam{T(g.fu), T(g.fv), T(g.cu), T(g.cv), T(g.fb)};
  T* U18 = out;
  T* Hpp = out + static_cast<size_t>(g.N) * 18;
  T* gp = Hpp + static_cast<size_t>(g.K) * 36;
  T* hg = static_cast<T*>(g.hg);
  const T* rec = static_cast<const T*>(g.rec);
  if (tid < 12) pose_s[tid] = __ldg(poses + 12 * static_cast<size_t>(k) + tid);
  const int s0 = g.ps_start[k], s1 = g.ps_start[k + 1];
  const bool free_pose = g.free_pose[k], contig = g.ps_contig[k];
  T acc[kRed];
#pragma unroll
  for (int r = 0; r < kRed; ++r) acc[r] = T(0);
  __syncthreads();

  for (int base = s0; base < s1; base += kThreads) {
    const int cnt = min(kThreads, s1 - base);
    const int s = base + tid;
    // a contiguous chunk's U18 span starts at element g0; the stage is
    // shifted so that it shares g0's offset within a 16-byte word
    const size_t g0 = contig ? 18 * static_cast<size_t>(g.ps_obs[base]) : 0;
    T* ust = smem + g0 % V;
    T* hst = smem + kUStage;
    T* um = ust + 18 * tid;
    T* hm = hst + kLm * tid;
    bool ok = false;
    T v[kRec], p[3];
    if (tid < cnt) {
      obs_s[tid] = g.ps_obs[s];
      ok = g.ps_valid[s];
      load_rec(rec + kRec * static_cast<size_t>(s), v);
      const T* pj = points + 3 * static_cast<size_t>(g.ps_point[s]);
      p[0] = __ldg(pj); p[1] = __ldg(pj + 1); p[2] = __ldg(pj + 2);
    }
    T u[18], h[kLm];
    if (ok) {
      T rw[3], Jp[3][6], Jl[3][3];
      factor<T>(cam, pose_s, p, v, rw, Jp, Jl);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b)
          acc[tri(a, b)] += Jp[0][a] * Jp[0][b] + Jp[1][a] * Jp[1][b] + Jp[2][a] * Jp[2][b];
        acc[21 + a] += Jp[0][a] * rw[0] + Jp[1][a] * rw[1] + Jp[2][a] * rw[2];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          u[3 * a + c] = free_pose
                             ? Jp[0][a] * Jl[0][c] + Jp[1][a] * Jl[1][c] + Jp[2][a] * Jl[2][c]
                             : T(0);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          h[3 * a + c] = Jl[0][a] * Jl[0][c] + Jl[1][a] * Jl[1][c] + Jl[2][a] * Jl[2][c];
        h[9 + a] = Jl[0][a] * rw[0] + Jl[1][a] * rw[1] + Jl[2][a] * rw[2];
      }
    } else {
#pragma unroll
      for (int c = 0; c < 18; ++c) u[c] = T(0);
#pragma unroll
      for (int c = 0; c < kLm; ++c) h[c] = T(0);
    }
    // into the stage in pairs (8 or 16 bytes; a quarter warp's 16-byte
    // stores at a 144-byte pitch fall on distinct banks)
#pragma unroll
    for (int m = 0; m < 9; ++m) reinterpret_cast<P*>(um)[m] = P{u[2 * m], u[2 * m + 1]};
#pragma unroll
    for (int m = 0; m < kLm / 2; ++m) reinterpret_cast<P*>(hm)[m] = P{h[2 * m], h[2 * m + 1]};
    __syncthreads();

    const int E = 18 * cnt;
    if (contig) {
      T* dst = U18 + g0;
      const int head = static_cast<int>((V - g0 % V) % V);  // scalars up to a word boundary
      const int words = (E - head) / V;
      if (tid < head) dst[tid] = ust[tid];
      const W* src = reinterpret_cast<const W*>(ust + head);
      W* dw = reinterpret_cast<W*>(dst + head);
      for (int i = tid; i < words; i += kThreads) dw[i] = src[i];
      for (int e = head + V * words + tid; e < E; e += kThreads) dst[e] = ust[e];
    } else {
      for (int e = tid; e < E; e += kThreads) {
        const int r = e / 18;
        U18[18 * static_cast<size_t>(obs_s[r]) + (e - 18 * r)] = ust[e];
      }
    }
    {
      const W* src = reinterpret_cast<const W*>(hst);
      W* dw = reinterpret_cast<W*>(hg + kLm * static_cast<size_t>(base));
      for (int i = tid; i < kLm * cnt / V; i += kThreads) dw[i] = src[i];
    }
    __syncthreads();  // the stage is rewritten by the next pass and the reduction
  }

  // fixed-order pose reduction: partial q of a value sums threads q, q + 16,
  // ..., q + 112 (16 lanes on 16 distinct banks), then the 16 partials in order
  T* red = smem;
#pragma unroll
  for (int r = 0; r < kRed; ++r) red[r * kPitch + tid] = acc[r];
  __syncthreads();
  for (int item = tid; item < kRed * kParts; item += kThreads) {
    const T* row = red + (item / kParts) * kPitch + item % kParts;
    T x = T(0);
#pragma unroll
    for (int i = 0; i < kThreads / kParts; ++i) x += row[kParts * i];
    part[item] = x;
  }
  __syncthreads();
  if (tid < 42) {
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
    x = free_pose ? x : T(0);
    if (tid < 36) {
      Hpp[36 * static_cast<size_t>(k) + tid] = x;
    } else {
      gp[6 * static_cast<size_t>(k) + (tid - 36)] = x;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLmThreads) landmark_kernel(const Plan g, T* __restrict__ out) {
  const int i = blockIdx.x * kLmThreads + threadIdx.x;
  const int j = i / kLm, r = i - kLm * j;
  if (j >= g.J) return;
  const int s0 = g.pt_start[j], s1 = g.pt_start[j + 1];
  const bool valid = g.point_valid[j];
  const T* hg = static_cast<const T*>(g.hg);
  // in slot order, kBatch slots at a time: their positions, then their
  // values, all in flight together, then the sums
  T x = T(0);
  for (int s = s0; s < s1; s += kBatch) {
    int q[kBatch];
    T h[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) q[i] = s + i < s1 ? g.pt_q[s + i] : -1;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      h[i] = q[i] >= 0 ? __ldg(hg + kLm * static_cast<size_t>(q[i]) + r) : T(0);
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (q[i] >= 0) x += h[i];
  }
  x = valid ? x : T(0);
  T* Hll = out + static_cast<size_t>(g.N) * 18 + static_cast<size_t>(g.K) * 42;
  if (r < 9) {
    Hll[9 * static_cast<size_t>(j) + r] = x;
  } else {
    Hll[9 * static_cast<size_t>(g.J) + 3 * static_cast<size_t>(j) + (r - 9)] = x;
  }
}

template <typename T>
int launch(const Plan* g, const T* poses, const T* points, T* out, void* stream) {
  if (g->K < 1 || g->J < 1 || g->N < 1) return static_cast<int>(cudaErrorInvalidValue);
  int current = g->device;
  if (g->multi_device) cudaGetDevice(&current);
  if (current != g->device) cudaSetDevice(g->device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pose_kernel<T><<<g->K, kThreads, 0, s>>>(*g, poses, points, out);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    landmark_kernel<T><<<(g->J * kLm + kLmThreads - 1) / kLmThreads, kLmThreads, 0, s>>>(*g, out);
    err = cudaGetLastError();
  }
  if (current != g->device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int stereo_factor_sums_f32(const Plan* g, const float* poses, const float* points, float* out,
                           void* stream) {
  return launch<float>(g, poses, points, out, stream);
}

int stereo_factor_sums_f64(const Plan* g, const double* poses, const double* points,
                           double* out, void* stream) {
  return launch<double>(g, poses, points, out, stream);
}

}  // extern "C"
