// Per-observation stereo factor blocks (K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::stereo_factor_blocks (body _stereo_kernel, math _stereo_math), the
// factor pass of the full-batch Schur-PCG assembly (solver/pcg.py
// ::build_obs_blocks). For every observation n, from its gathered pose
// T[n] ([t | R row-major]), point p[n], measurement uvd[n], 3x3 stiffness
// S[n] and validity valid[n], it evaluates the whitened stereo residual
// r = w S (project(R p + t) - uvd) with the tangent Jacobians
// J_pose = w S Jproj [I | -p_c^] and J_pt = w S Jproj R (w = valid ? 1 : 0)
// and emits, row-major with the observation index slowest,
//   r   [N, 3]    hpp [N, 36] J_pose^T J_pose    hll [N, 9] J_pt^T J_pt
//   u   [N, 18]   J_pose^T J_pt                  gp  [N, 6] J_pose^T r
//   gl  [N, 3]    J_pt^T r
// The TPU's lane-major [rows, N] transposes and its multiple-of-512
// padding are gone: inputs and outputs keep the per-observation layout
// the PCG code uses, and the ragged last block is masked.
//
// What bounds it on an H100: memory. Per observation it reads 28 values
// and writes 75: ~103 MB per call at kitti1100 full batch (N = 124,480)
// in float64, ~31 us at 3.35 TB/s; at triangle200 (N = 12,992, ~10 MB)
// the launch dominates.
//
// Design: one thread per observation keeps the factor evaluation in
// registers (the same algebra as csrc/window_factor_blocks.cu). No
// reduction happens here: the caller sums the blocks by pose and by
// landmark through its gather tables, deterministically. Fusing those
// reductions into this kernel, and staging the 75 outputs through shared
// memory so the stores coalesce, are later optimisations. The depth is
// guarded (z == 0 -> 1) before 1/z so a masked row cannot turn 0 * inf
// into NaN.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads) stereo_factor_kernel(
    const T* __restrict__ poses, const T* __restrict__ points, const T* __restrict__ uvd,
    const T* __restrict__ stiffness, const unsigned char* __restrict__ valid, T fu, T fv, T cu,
    T cv, T fb, int N, T* __restrict__ r_out, T* __restrict__ hpp, T* __restrict__ hll,
    T* __restrict__ u, T* __restrict__ gp, T* __restrict__ gl) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const size_t m = static_cast<size_t>(n);
  const T* P = poses + 12 * m;
  const T* p = points + 3 * m;
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
  const T* obs = uvd + 3 * m;
  const T res[3] = {fu * pc[0] * iz + cu - obs[0], fv * pc[1] * iz + cv - obs[1],
                    fb * iz - obs[2]};
  const T Jproj[3][3] = {{fu * iz, T(0), -fu * pc[0] * iz2},
                         {T(0), fv * iz, -fv * pc[1] * iz2},
                         {T(0), T(0), -fb * iz2}};
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

  // whiten by the stiffness, mask by validity
  const T w = valid[n] ? T(1) : T(0);
  const T* Sm = stiffness + 9 * m;
  T S[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) S[a][b] = Sm[3 * a + b];
  T rw[3], Jw_pose[3][6], Jw_pt[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rw[a] = w * (S[a][0] * res[0] + S[a][1] * res[1] + S[a][2] * res[2]);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Jw_pose[a][j] = w * (S[a][0] * Jpose[0][j] + S[a][1] * Jpose[1][j] + S[a][2] * Jpose[2][j]);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jw_pt[a][j] = w * (S[a][0] * Jpt[0][j] + S[a][1] * Jpt[1][j] + S[a][2] * Jpt[2][j]);
  }

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r_out[3 * m + a] = rw[a];
    gl[3 * m + a] = Jw_pt[0][a] * rw[0] + Jw_pt[1][a] * rw[1] + Jw_pt[2][a] * rw[2];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      hll[9 * m + 3 * a + b] =
          Jw_pt[0][a] * Jw_pt[0][b] + Jw_pt[1][a] * Jw_pt[1][b] + Jw_pt[2][a] * Jw_pt[2][b];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    gp[6 * m + a] = Jw_pose[0][a] * rw[0] + Jw_pose[1][a] * rw[1] + Jw_pose[2][a] * rw[2];
#pragma unroll
    for (int b = 0; b < 6; ++b)
      hpp[36 * m + 6 * a + b] = Jw_pose[0][a] * Jw_pose[0][b] + Jw_pose[1][a] * Jw_pose[1][b] +
                                Jw_pose[2][a] * Jw_pose[2][b];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      u[18 * m + 3 * a + b] =
          Jw_pose[0][a] * Jw_pt[0][b] + Jw_pose[1][a] * Jw_pt[1][b] + Jw_pose[2][a] * Jw_pt[2][b];
  }
}

template <typename T>
int launch(const T* poses, const T* points, const T* uvd, const T* stiffness,
           const unsigned char* valid, double fu, double fv, double cu, double cv, double b,
           int N, T* r, T* hpp, T* hll, T* u, T* gp, T* gl, void* stream) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  stereo_factor_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      poses, points, uvd, stiffness, valid, T(fu), T(fv), T(cu), T(cv), T(fu * b), N, r, hpp,
      hll, u, gp, gl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stereo_factor_blocks_f32(const float* poses, const float* points, const float* uvd,
                             const float* stiffness, const unsigned char* valid, double fu,
                             double fv, double cu, double cv, double b, int N, float* r,
                             float* hpp, float* hll, float* u, float* gp, float* gl,
                             void* stream) {
  return launch<float>(poses, points, uvd, stiffness, valid, fu, fv, cu, cv, b, N, r, hpp, hll,
                       u, gp, gl, stream);
}

int stereo_factor_blocks_f64(const double* poses, const double* points, const double* uvd,
                             const double* stiffness, const unsigned char* valid, double fu,
                             double fv, double cu, double cv, double b, int N, double* r,
                             double* hpp, double* hll, double* u, double* gp, double* gl,
                             void* stream) {
  return launch<double>(poses, points, uvd, stiffness, valid, fu, fv, cu, cv, b, N, r, hpp,
                        hll, u, gp, gl, stream);
}

}  // extern "C"
