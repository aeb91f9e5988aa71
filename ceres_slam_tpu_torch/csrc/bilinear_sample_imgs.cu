// Bilinear sampling of a packed image stack at scattered points (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::bilinear_sample_imgs (body _bilinear_kernel), which samples the track
// image and its two gradients of dense photometric alignment at the warped
// pixel coordinates (ops/photometric.py, twice per LM iteration). For every
// point n and channel c,
//   ui = clip(floor(u[n]), 0, W-2)   vi = clip(floor(v[n]), 0, H-2)
//   fu = u[n] - ui                   fv = v[n] - vi
//   out[c, n] = (I[vi, ui] (1-fv) + I[vi+1, ui] fv) (1-fu)
//             + (I[vi, ui+1] (1-fv) + I[vi+1, ui+1] fv) fu      (I = channel c)
// Points outside the image get the clipped-border extrapolation; the
// caller masks them. The stack is packed channel-interleaved, tex [H, W, 4]
// (C <= 4 channels, the rest zero; ops/bilinear_kernel.py::pack_imgs, once
// per solve); u and v are [N] with any element stride (the path passes the
// columns of its [N, 3] projections, so nothing is copied); out is [C, N].
// All of one type, float or double.
//
// The TPU kernel moved the index arithmetic out of the kernel (a Mosaic
// limit on float->int conversions) and turned the gather into two one-hot
// MXU contractions against a VMEM-resident image. Both are TPU matters:
// here each thread computes its own indices and reads its texels directly.
//
// What bounds it on an H100: memory. Per call it must read the stack
// (C*H*W values) and the coordinates (2N) and write C*N values: at 240x320
// with N = 68,096 in float32 that is 2.28 MB, 0.68 us at 3.35 TB/s; at
// 375x1242 with N = 440,134 it is 14.4 MB, 4.3 us (8.6 us in float64). The
// arithmetic (~35 operations a point) is far below the card's rate. With
// random points the stack's traffic from L2 dominates: a channel-planar
// stack costs each point 4 texels x C planes, 6-12 separate 32-byte
// sectors; packed, a point's 2x2 neighbourhood is two rows of two adjacent
// texels, one 16-byte vector load each in float32 (two in float64), 2-4
// sectors in float32 (4-6 in float64).
//
// Design: one thread per point; the packed stack (7.5 MB at 375x1242 in
// float32) stays in the 50 MB L2. The [C, N] stores coalesce across the
// warp. The products go through __fmul_rn/__dmul_rn, which the compiler
// never contracts into an FMA, so the kernel rounds exactly as the plain
// PyTorch version does (elementwise ops, one rounding each) and the two
// agree bit for bit. Non-finite or huge coordinates (a point behind the
// camera, a disparity of 0) are clamped in floating point before the
// integer conversion: fmax(NaN, 0) is 0, so no index leaves the image.

#include <cuda_runtime.h>

// The plan of one packed stack, fixed over a solve (mirrors
// ops/bilinear_kernel.py::_Args). Outside the anonymous namespace: the
// extern "C" entry points take it, and would not be exported otherwise.
struct Args {
  const void* tex;  // [H, W, 4]
  int H, W, C, device;
  int multi_device;  // more than one device visible: launch on `device`
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
// clamp to [0, hi]; a NaN becomes 0 (fmax returns the other operand)
__device__ __forceinline__ float clamp_to(float x, float hi) { return fminf(fmaxf(x, 0.0f), hi); }
__device__ __forceinline__ double clamp_to(double x, double hi) { return fmin(fmax(x, 0.0), hi); }

// the four channels of one texel: one 16-byte load (float), two (double)
__device__ __forceinline__ void load_texel(const float* p, float t[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  t[0] = q.x; t[1] = q.y; t[2] = q.z; t[3] = q.w;
}
__device__ __forceinline__ void load_texel(const double* p, double t[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bilinear_packed_kernel(
    const T* __restrict__ tex, int H, int W, int C, const T* __restrict__ u, long long su,
    const T* __restrict__ v, long long sv, int N, T* __restrict__ out) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T un = __ldg(u + n * su);
  const T vn = __ldg(v + n * sv);
  const T uf = clamp_to(floor_of(un), T(W - 2));
  const T vf = clamp_to(floor_of(vn), T(H - 2));
  const T fu = un - uf;
  const T fv = vn - vf;
  const T gu = T(1) - fu;
  const T gv = T(1) - fv;
  const T* p = tex + (static_cast<size_t>(vf) * W + static_cast<size_t>(uf)) * 4;
  T t00[4], t01[4], t10[4], t11[4];
  load_texel(p, t00);
  load_texel(p + 4, t01);
  load_texel(p + 4 * static_cast<size_t>(W), t10);
  load_texel(p + 4 * static_cast<size_t>(W) + 4, t11);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < C) {
      const T col0 = mul(t00[c], gv) + mul(t10[c], fv);
      const T col1 = mul(t01[c], gv) + mul(t11[c], fv);
      out[static_cast<size_t>(c) * N + n] = mul(col0, gu) + mul(col1, fu);
    }
  }
}

template <typename T>
int launch(const Args* a, const T* u, long long su, const T* v, long long sv, int N, T* out,
           void* stream) {
  if (a->C < 1 || a->C > 4 || a->H < 2 || a->W < 2 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = a->device;
  if (a->multi_device) cudaGetDevice(&current);
  if (current != a->device) cudaSetDevice(a->device);
  bilinear_packed_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a->tex), a->H, a->W, a->C, u, su, v, sv, N, out);
  const cudaError_t err = cudaGetLastError();
  if (current != a->device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int bilinear_sample_packed_f32(const Args* a, const float* u, long long su, const float* v,
                               long long sv, int N, float* out, void* stream) {
  return launch<float>(a, u, su, v, sv, N, out, stream);
}

int bilinear_sample_packed_f64(const Args* a, const double* u, long long su, const double* v,
                               long long sv, int N, double* out, void* stream) {
  return launch<double>(a, u, su, v, sv, N, out, stream);
}

}  // extern "C"
