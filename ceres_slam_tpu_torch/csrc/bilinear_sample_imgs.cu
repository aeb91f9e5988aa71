// Bilinear sampling of an image stack at scattered points (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel ceres_slam_tpu/ops/pallas_kernels.py
// ::bilinear_sample_imgs (body _bilinear_kernel), which samples the track
// image and its two gradients of dense photometric alignment at the warped
// pixel coordinates (ops/photometric.py, twice per LM iteration). For every
// point n and channel c,
//   ui = clip(floor(u[n]), 0, W-2)   vi = clip(floor(v[n]), 0, H-2)
//   fu = u[n] - ui                   fv = v[n] - vi
//   out[c, n] = (I[vi, ui] (1-fv) + I[vi+1, ui] fv) (1-fu)
//             + (I[vi, ui+1] (1-fv) + I[vi+1, ui+1] fv) fu      (I = imgs[c])
// Points outside the image get the clipped-border extrapolation; the
// caller masks them. imgs is [C, H, W], u and v are [N], out is [C, N],
// all contiguous and of one type (float or double).
//
// The TPU kernel moved the index arithmetic out of the kernel (a Mosaic
// limit on float->int conversions) and turned the gather into two one-hot
// MXU contractions against a VMEM-resident image. Both are TPU matters:
// here each thread computes its own indices and reads its four texels per
// channel directly.
//
// What bounds it on an H100: memory, and at the photometric path's sizes
// the launch. Per call it must read the stack (C*H*W values) and the
// coordinates (2N) and write C*N values: at 240x320 with N = 68,096 in
// float32 that is 2.28 MB, 0.68 us at 3.35 TB/s; at 375x1242 with N =
// 440,134 it is 14.4 MB, 4.3 us (8.6 us in float64). The arithmetic (~35
// operations a point) is far below the card's rate.
//
// Design: one thread per point. The four texels of each channel are read
// through the read-only path (__ldg); the whole stack (0.9 MB at 240x320,
// 5.6 MB at 375x1242 in float32) fits in the 50 MB L2, so the neighbouring
// and repeated reads of nearby points hit it. The [C, N] stores coalesce
// across the warp. The products go through __fmul_rn/__dmul_rn, which the
// compiler never contracts into an FMA, so the kernel rounds exactly as the
// plain PyTorch version does (elementwise ops, one rounding each) and the
// two agree bit for bit. Non-finite or huge coordinates (a point behind the
// camera, a disparity of 0) are clamped in floating point before the
// integer conversion: fmax(NaN, 0) is 0, so no index leaves the image.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
// clamp to [0, hi]; a NaN becomes 0 (fmax returns the other operand)
__device__ __forceinline__ float clamp_to(float x, float hi) { return fminf(fmaxf(x, 0.0f), hi); }
__device__ __forceinline__ double clamp_to(double x, double hi) { return fmin(fmax(x, 0.0), hi); }

template <typename T>
__global__ void __launch_bounds__(kThreads) bilinear_kernel(
    const T* __restrict__ imgs, const T* __restrict__ u, const T* __restrict__ v, int C, int H,
    int W, int N, T* __restrict__ out) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const T un = __ldg(u + n);
  const T vn = __ldg(v + n);
  const T uf = clamp_to(floor_of(un), T(W - 2));
  const T vf = clamp_to(floor_of(vn), T(H - 2));
  const T fu = un - uf;
  const T fv = vn - vf;
  const T gu = T(1) - fu;
  const T gv = T(1) - fv;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* p = imgs + static_cast<size_t>(vf) * W + static_cast<size_t>(uf);
  T* o = out + n;
  for (int c = 0; c < C; ++c, p += plane, o += N) {
    const T i00 = __ldg(p), i01 = __ldg(p + 1);
    const T i10 = __ldg(p + W), i11 = __ldg(p + W + 1);
    const T col0 = mul(i00, gv) + mul(i10, fv);
    const T col1 = mul(i01, gv) + mul(i11, fv);
    *o = mul(col0, gu) + mul(col1, fu);
  }
}

template <typename T>
int launch(const T* imgs, const T* u, const T* v, int C, int H, int W, int N, T* out,
           void* stream) {
  if (C < 1 || H < 2 || W < 2 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  bilinear_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(imgs, u, v, C, H, W, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bilinear_sample_imgs_f32(const float* imgs, const float* u, const float* v, int C, int H,
                             int W, int N, float* out, void* stream) {
  return launch<float>(imgs, u, v, C, H, W, N, out, stream);
}

int bilinear_sample_imgs_f64(const double* imgs, const double* u, const double* v, int C,
                             int H, int W, int N, double* out, void* stream) {
  return launch<double>(imgs, u, v, C, H, W, N, out, stream);
}

}  // extern "C"
