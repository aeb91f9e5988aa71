// Coupling half of the Schur-complement matvec (K3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::schur_uy_packed (phases _uy_phase1_kernel and _uy_phase2_kernel, with
// the small XLA step y = Cinv utv between them). For the reduced camera
// system S v = Hpp v - U C^-1 U^T v of full-batch bundle adjustment it
// computes
//   y_j  = Cinv_j sum_{n in obs(j)} U_n^T v[pose(n)]        (phase 1)
//   Uy_k = sum_{n in obs(k)} U_n y[point(n)]                 (phase 2)
// with U_n the 6x3 pose-landmark coupling of observation n, stored
// component-flat U18[n, 3a + c] = U_n[a, c], in observation order. The
// observations of landmark j and of pose k are the segments of the
// full-batch plan (ops/full_batch_plan.py): pt_obs[pt_start[j] ..
// pt_start[j + 1]) with their poses pt_pose, and ps_obs[ps_start[k] ..
// ps_start[k + 1]) with their landmarks ps_point, both in increasing
// observation id. The observations are NOT stored pose by pose in general
// (a window problem ends with padding rows at pose 0), so the pose
// segments are a grouping, and phase 2 reads U18 rows by index.
//
// What bounds it on an H100: memory. The function reads U18 (18 values an
// observation), Cinv, v and one pose and one landmark index an
// observation, and writes Uy: 20.2 MB at kitti1100 full batch (N =
// 124,480, J = 16,640, K = 1,100) in float64, 6.0 us at 3.35 TB/s. Both
// phases read U18. Measured (PERF.md), each phase takes ~4 us of fixed
// latency chain (segment bounds, then indices, then rows, a barrier, the
// sums) plus its bytes at ~5 TB/s, i.e. mostly from the L2: float32,
// with half the bytes, is only ~20% faster, more blocks per SM change
// nothing, and an L2 evict_last hint on U18 changed nothing.
//
// Design. The PR 2 form gave a warp to each landmark and each pose (~8
// warps an SM in phase 2, ~24 of 32 lanes idle on a typical landmark of
// ~7.5 observations in phase 1), and each thread loaded whole 144-byte rows
// of U18 value by value: one warp load then touched 32 rows, ~32 L1
// wavefronts for 256 useful bytes, which bounds such a kernel at ~14 us
// for phase 1 alone at kitti1100.
// - Rows are staged: a block lists its slots' observations in shared
//   memory, then copies their U18 rows into a shared stage as 16-byte
//   (8-byte) pairs, consecutive threads on consecutive pairs, a thread's
//   loads in flight together: a warp load covers 3-4 rows, a warp
//   store 512 (256) contiguous bytes. A thread then reads its slot's row
//   from the stage in pairs (a 144-byte pitch puts a quarter warp's 16-byte
//   reads on distinct banks).
// - Phase 1: a block per landmark group of the plan (whole landmarks, at
//   most 128 slots and 32 landmarks: ~17 landmarks at kitti1100, ~4 at
//   triangle200, whose landmarks have ~32 observations; a landmark with
//   more slots is a group alone and its block takes them 128 at a time), a
//   thread per slot for U_n^T v[pose(n)]; then a thread per landmark and
//   component sums its slots in slot order and applies Cinv_j (which fuses
//   the TPU's middle XLA step) into the plan's y, padded to 4 values.
// - Phase 2: a 128-thread block per pose over its ~113 slots, a thread per
//   slot for U_n y[point(n)] (its y loaded with its row), then a fixed
//   shuffle tree per warp and the four warps' sums in order through shared
//   memory.
// - Two launches. Phase 2 needs every y: one launch would need a grid-wide
//   barrier. A programmatic dependent launch of phase 2 (staging its rows
//   while phase 1 drains) measured no faster than two plain launches on the
//   H100 (PERF.md), and is not used.
// - schur_sp: the same two phases as the matvec of a CG iteration
//   (solver/pcg.py), phase 2 also forming Sp = Hpp p - Uy and each pose's
//   share of p . Sp (uy_pose_cg_kernel); csrc/cg_step.cu runs the rest of
//   the iteration.
// No atomics: the result is identical run to run. No tensor cores, no TF32.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "full_batch_plan.h"

// K3's arguments fixed over an LM iteration (ops/schur_kernel.py::_UyArgs).
struct UyArgs {
  Plan plan;
  const void* U18;
  const void* cinv;
};

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;    // blocks an SM: <= 64 registers a thread, one wave at kitti1100
constexpr int kLmPerBlock = kGroupLandmarks;  // phase 1: most landmarks a group
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Pair;  // two values of T in one load: U18 rows are 16-byte (8-byte) aligned
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// Copy the U18 rows of observations rows[0 .. cnt) (cnt <= kThreads) into
// stage[18 r ..], pair q of the stage being pair q % 9 of row q / 9. A
// thread's nine loads are issued in rounds of kRound<T> (all nine in float32;
// five then four in float64, which keeps the kernels within 64 registers
// without spilling), each round's loads before any of its stores.
template <typename T>
constexpr int kRound = sizeof(T) == 8 ? 5 : 9;

template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ U18, const int* rows, int cnt,
                                           T* stage) {
  using P = typename Pair<T>::type;
#pragma unroll
  for (int i0 = 0; i0 < 9; i0 += kRound<T>) {
    P x[kRound<T>];
#pragma unroll
    for (int i = 0; i < kRound<T>; ++i) {
      const int q = threadIdx.x + kThreads * (i0 + i), r = q / 9;
      if (i0 + i < 9 && q < 9 * cnt)
        x[i] = __ldg(reinterpret_cast<const P*>(U18 + 18 * static_cast<size_t>(rows[r])) +
                     (q - 9 * r));
    }
#pragma unroll
    for (int i = 0; i < kRound<T>; ++i) {
      const int q = threadIdx.x + kThreads * (i0 + i);
      if (i0 + i < 9 && q < 9 * cnt) reinterpret_cast<P*>(stage)[q] = x[i];
    }
  }
}

// A slot's staged row, in pairs.
template <typename T>
__device__ __forceinline__ void read_row(const T* stage, int r, T u[18]) {
  using P = typename Pair<T>::type;
  const P* row = reinterpret_cast<const P*>(stage) + 9 * r;
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const P x = row[m];
    u[2 * m] = x.x;
    u[2 * m + 1] = x.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    uy_point_kernel(const Plan g, const T* __restrict__ U18, const T* __restrict__ cinv,
                    const T* __restrict__ v) {
  using P = typename Pair<T>::type;
  __shared__ __align__(16) T stage[kThreads * 18];
  __shared__ T tv[kThreads * 3];
  __shared__ T utv[kLmPerBlock * 3];
  __shared__ int rows[kThreads];
  __shared__ int start[kLmPerBlock + 1];
  const int tid = threadIdx.x, j0 = g.lm_group[blockIdx.x];
  const int nl = g.lm_group[blockIdx.x + 1] - j0;
  if (tid <= nl) start[tid] = g.pt_start[j0 + tid];
  // thread (l, b), tid < 3 nl: landmark j0 + l's component b, and row b of its Cinv
  const int l = tid / 3, b = tid - 3 * (tid / 3);
  const bool lm = tid < 3 * nl;
  T C0 = T(0), C1 = T(0), C2 = T(0);
  if (lm) {
    const T* C = cinv + 9 * static_cast<size_t>(j0 + l) + 3 * b;
    C0 = __ldg(C); C1 = __ldg(C + 1); C2 = __ldg(C + 2);
  }
  __syncthreads();
  const int s0 = start[0], s1 = start[nl];
  T acc = T(0);
  for (int base = s0; base < s1; base += kThreads) {
    const int cnt = min(kThreads, s1 - base);
    int k = 0;
    if (tid < cnt) {
      rows[tid] = g.pt_obs[base + tid];
      k = g.pt_pose[base + tid];
    }
    __syncthreads();
    stage_rows(U18, rows, cnt, stage);
    P vk[3];  // in flight across the barrier
    if (tid < cnt) {
      const P* vp = reinterpret_cast<const P*>(v + 6 * static_cast<size_t>(k));
#pragma unroll
      for (int m = 0; m < 3; ++m) vk[m] = __ldg(vp + m);
    }
    __syncthreads();
    if (tid < cnt) {
      T u[18];
      read_row(stage, tid, u);
      const T va[6] = {vk[0].x, vk[0].y, vk[1].x, vk[1].y, vk[2].x, vk[2].y};
      T t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        t0 += u[3 * a] * va[a];
        t1 += u[3 * a + 1] * va[a];
        t2 += u[3 * a + 2] * va[a];
      }
      tv[3 * tid] = t0; tv[3 * tid + 1] = t1; tv[3 * tid + 2] = t2;
    }
    __syncthreads();
    if (lm) {  // the landmark's slots in this pass, in slot order
      const int lo = max(start[l], base), hi = min(start[l + 1], base + cnt);
      for (int s = lo; s < hi; ++s) acc += tv[3 * (s - base) + b];
    }
    __syncthreads();
  }
  if (lm) utv[tid] = acc;
  __syncthreads();
  if (lm)
    static_cast<T*>(g.y)[4 * static_cast<size_t>(j0 + l) + b] =
        C0 * utv[3 * l] + C1 * utv[3 * l + 1] + C2 * utv[3 * l + 2];
}

// Pose k's Uy_k = sum_{n in obs(k)} U_n y[point(n)]: returns component tid
// to threads tid < 6 (the block's threads all call it).
template <typename T>
__device__ __forceinline__ T pose_uy(const Plan& g, const T* __restrict__ U18, int k, T* stage,
                                     int* rows, T (*part)[6]) {
  using P = typename Pair<T>::type;
  const int tid = threadIdx.x;
  const int s0 = g.ps_start[k], s1 = g.ps_start[k + 1];
  const P* y = static_cast<const P*>(g.y);  // [J, 4]: two pairs a landmark
  T acc[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = T(0);
  for (int base = s0; base < s1; base += kThreads) {
    const int cnt = min(kThreads, s1 - base);
    int j = 0;
    if (tid < cnt) {
      rows[tid] = g.ps_obs[base + tid];
      j = g.ps_point[base + tid];
    }
    __syncthreads();
    stage_rows(U18, rows, cnt, stage);
    P yj[2];  // in flight across the barrier
    if (tid < cnt) {
      yj[0] = __ldg(y + 2 * static_cast<size_t>(j));
      yj[1] = __ldg(y + 2 * static_cast<size_t>(j) + 1);
    }
    __syncthreads();
    if (tid < cnt) {
      T u[18];
      read_row(stage, tid, u);
      const T y0 = yj[0].x, y1 = yj[0].y, y2 = yj[1].x;
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[a] += u[3 * a] * y0 + u[3 * a + 1] * y1 + u[3 * a + 2] * y2;
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[a] += __shfl_xor_sync(kFull, acc[a], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) part[tid >> 5][a] = acc[a];
  }
  __syncthreads();
  T x = T(0);
  if (tid < 6) {
    x = part[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) x += part[w][tid];
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    uy_pose_kernel(const Plan g, const T* __restrict__ U18, T* __restrict__ out) {
  __shared__ __align__(16) T stage[kThreads * 18];
  __shared__ int rows[kThreads];
  __shared__ T part[kThreads / 32][6];
  const int k = blockIdx.x, tid = threadIdx.x;
  const T x = pose_uy(g, U18, k, stage, rows, part);
  if (tid < 6) out[6 * static_cast<size_t>(k) + tid] = x;
}

// The pose phase of a CG iteration (cg_step.cu runs the rest): beside Uy_k,
// block k forms Sp_k = Hpp_k p_k - Uy_k of the damped pose block and its
// share p_k . Sp_k of the iteration's first dot (the six products summed
// in order), so the CG iteration needs no separate Hpp p product, difference
// or dot. Hpp_k and p_k reach shared memory by asynchronous copies issued
// before the slot loop, so their latency hides behind it.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    uy_pose_cg_kernel(const Plan g, const T* __restrict__ U18, const T* __restrict__ hpp,
                      const T* __restrict__ p, T* __restrict__ sp, T* __restrict__ dots) {
  __shared__ __align__(16) T stage[kThreads * 18];
  __shared__ int rows[kThreads];
  __shared__ T part[kThreads / 32][6];
  __shared__ T hs[36 + 6];  // Hpp_k row by row, then p_k
  __shared__ T prod[6];
  const int k = blockIdx.x, tid = threadIdx.x;
  if (tid < 36)
    __pipeline_memcpy_async(hs + tid, hpp + 36 * static_cast<size_t>(k) + tid, sizeof(T));
  else if (tid < 42)
    __pipeline_memcpy_async(hs + tid, p + 6 * static_cast<size_t>(k) + tid - 36, sizeof(T));
  __pipeline_commit();
  const T x = pose_uy(g, U18, k, stage, rows, part);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid < 6) {
    const T* pk = hs + 36;
    T hp = T(0);
#pragma unroll
    for (int b = 0; b < 6; ++b) hp += hs[6 * tid + b] * pk[b];
    const T s = hp - x;
    sp[6 * static_cast<size_t>(k) + tid] = s;
    prod[tid] = pk[tid] * s;  // rounded alone, as PyTorch's product
    __syncwarp(0x3fu);
    if (tid == 0) dots[k] = prod[0] + prod[1] + prod[2] + prod[3] + prod[4] + prod[5];
  }
}

// Phase 1, then phase 2: K3's (out = Uy) or, with hpp, the CG iteration's
// (sp = Hpp p - Uy and the dot shares, v being p).
template <typename T>
int launch(const UyArgs* a, const T* v, T* out, const T* hpp, T* dots, void* stream) {
  const Plan& g = a->plan;
  // a group of more landmarks would overrun phase 1's shared arrays
  if (g.J < 1 || g.K < 1 || g.N < 1 || g.G < 1 || g.max_group < 1 || g.max_group > kLmPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = g.device;
  if (g.multi_device) cudaGetDevice(&current);
  if (current != g.device) cudaSetDevice(g.device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* U18 = static_cast<const T*>(a->U18);
  uy_point_kernel<T><<<g.G, kThreads, 0, s>>>(g, U18, static_cast<const T*>(a->cinv), v);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    if (hpp == nullptr)
      uy_pose_kernel<T><<<g.K, kThreads, 0, s>>>(g, U18, out);
    else
      uy_pose_cg_kernel<T><<<g.K, kThreads, 0, s>>>(g, U18, hpp, v, out, dots);
    err = cudaGetLastError();
  }
  if (current != g.device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int schur_uy_f32(const UyArgs* a, const float* v, float* out, void* stream) {
  return launch<float>(a, v, out, nullptr, nullptr, stream);
}

int schur_uy_f64(const UyArgs* a, const double* v, double* out, void* stream) {
  return launch<double>(a, v, out, nullptr, nullptr, stream);
}

int schur_sp_f32(const UyArgs* a, const float* p, const float* hpp, float* sp, float* dots,
                 void* stream) {
  return launch<float>(a, p, sp, hpp, dots, stream);
}

int schur_sp_f64(const UyArgs* a, const double* p, const double* hpp, double* sp, double* dots,
                 void* stream) {
  return launch<double>(a, p, sp, hpp, dots, stream);
}

}  // extern "C"
