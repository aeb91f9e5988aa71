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
// component-flat U18[n, 3a + c] = U_n[a, c]. The observations of landmark
// j and of pose k are read through the solver's gather tables
// (solver/pcg.py ObsTables): by_point[j, o], by_pose[k, o] hold
// observation ids, by_point_pose / by_pose_point the pose / landmark of
// each slot, and the 0/1 weights mark the padding slots, which are skipped.
//
// What bounds it on an H100: memory. Each phase streams the 18 coupling
// values of every observation once: ~36 MB per call at kitti1100 full
// batch (N = 124,480) in float64, ~11 us at 3.35 TB/s, plus the tables
// (~6 MB). The TPU kernel read U through padded [J, O_l * 18] panels; O_l
// is the largest observation count of any landmark (36 at kitti1100
// against a mean of ~7), so the same panels here would be ~172 MB
// (~51 us). The tables address the flat U18 instead, and no permuted copy
// of U is made: the by-pose order is the dataset's own (observations are
// stored pose by pose), the by-landmark order costs scattered 144-byte
// row reads.
//
// Design: one warp per landmark (phase 1) and one warp per pose (phase 2).
// Lanes stride over the segment's slots, each keeps partial sums in
// registers, and a fixed xor-butterfly of warp shuffles adds them: no
// atomics, so the result is identical run to run. Phase 1 applies
// Cinv_j itself, which fuses the TPU's middle XLA step. There are no
// tensor cores and no TF32 anywhere.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one segment each
constexpr int kWarp = 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) uy_point_kernel(
    const T* __restrict__ U18, const int* __restrict__ by_point,
    const float* __restrict__ by_point_w, const int* __restrict__ by_point_pose,
    const T* __restrict__ cinv, const T* __restrict__ v, int J, int O_l, T* __restrict__ y) {
  const int j = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (j >= J) return;  // uniform per warp: the shuffles below see full warps
  const size_t row = static_cast<size_t>(j) * O_l;
  T s0 = T(0), s1 = T(0), s2 = T(0);
  for (int o = lane; o < O_l; o += kWarp) {
    const float w = by_point_w[row + o];
    if (w == 0.0f) continue;
    const T* u = U18 + 18 * static_cast<size_t>(by_point[row + o]);
    const T* vk = v + 6 * static_cast<size_t>(by_point_pose[row + o]);
    T t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const T va = vk[a];
      t0 += u[3 * a] * va;
      t1 += u[3 * a + 1] * va;
      t2 += u[3 * a + 2] * va;
    }
    s0 += T(w) * t0;
    s1 += T(w) * t1;
    s2 += T(w) * t2;
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const T* C = cinv + 9 * static_cast<size_t>(j);
#pragma unroll
    for (int b = 0; b < 3; ++b) y[3 * static_cast<size_t>(j) + b] = C[3 * b] * s0 + C[3 * b + 1] * s1 + C[3 * b + 2] * s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) uy_pose_kernel(
    const T* __restrict__ U18, const int* __restrict__ by_pose,
    const float* __restrict__ by_pose_w, const int* __restrict__ by_pose_point,
    const T* __restrict__ y, int K, int O_p, T* __restrict__ out) {
  const int k = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (k >= K) return;
  const size_t row = static_cast<size_t>(k) * O_p;
  T acc[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = T(0);
  for (int o = lane; o < O_p; o += kWarp) {
    const float w = by_pose_w[row + o];
    if (w == 0.0f) continue;
    const T* u = U18 + 18 * static_cast<size_t>(by_pose[row + o]);
    const T* yj = y + 3 * static_cast<size_t>(by_pose_point[row + o]);
    const T y0 = yj[0], y1 = yj[1], y2 = yj[2];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      acc[a] += T(w) * (u[3 * a] * y0 + u[3 * a + 1] * y1 + u[3 * a + 2] * y2);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[a] = warp_sum(acc[a]);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) out[6 * static_cast<size_t>(k) + a] = acc[a];
  }
}

template <typename T>
int launch(const T* U18, const int* by_point, const float* by_point_w, const int* by_point_pose,
           const int* by_pose, const float* by_pose_w, const int* by_pose_point, const T* cinv,
           const T* v, int J, int O_l, int K, int O_p, T* y, T* out, void* stream) {
  if (J < 1 || O_l < 1 || K < 1 || O_p < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kThreads / kWarp;
  uy_point_kernel<T><<<(J + per_block - 1) / per_block, kThreads, 0, s>>>(
      U18, by_point, by_point_w, by_point_pose, cinv, v, J, O_l, y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  uy_pose_kernel<T><<<(K + per_block - 1) / per_block, kThreads, 0, s>>>(
      U18, by_pose, by_pose_w, by_pose_point, y, K, O_p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int schur_uy_f32(const float* U18, const int* by_point, const float* by_point_w,
                 const int* by_point_pose, const int* by_pose, const float* by_pose_w,
                 const int* by_pose_point, const float* cinv, const float* v, int J, int O_l,
                 int K, int O_p, float* y, float* out, void* stream) {
  return launch<float>(U18, by_point, by_point_w, by_point_pose, by_pose, by_pose_w,
                       by_pose_point, cinv, v, J, O_l, K, O_p, y, out, stream);
}

int schur_uy_f64(const double* U18, const int* by_point, const float* by_point_w,
                 const int* by_point_pose, const int* by_pose, const float* by_pose_w,
                 const int* by_pose_point, const double* cinv, const double* v, int J, int O_l,
                 int K, int O_p, double* y, double* out, void* stream) {
  return launch<double>(U18, by_point, by_point_w, by_point_pose, by_pose, by_pose_w,
                        by_pose_point, cinv, v, J, O_l, K, O_p, y, out, stream);
}

}  // extern "C"
