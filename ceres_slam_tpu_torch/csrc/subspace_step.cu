// The 2x2 subproblem of SUBSPACE_DOGLEG for B windows, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: the JAX package computes this function
// with jnp operations inside its window loop's lax.while_loop
// (ceres_slam_tpu/solver/dogleg.py: subspace_step and _boundary_min). The
// port runs that loop in a CUDA graph's WHILE node, where the function as
// PyTorch operations (ceres_slam_tpu_torch/ops/subspace_kernel.py,
// subspace_step_plain) is ~13 small kernels per bisection step, ~830 per
// trust-region iteration. Here it is one kernel.
//
// Window b: model[b] = (B00, B01, B11, g0, g1), the trust radius radius[b];
// out[b] = (y0, y1, pred): the Newton point where B is positive definite
// and the point lies within the radius, else the boundary minimizer (the
// More-Sorensen solve in B's eigenbasis, 64 bisection steps on the
// multiplier, then the best of four candidates), and the predicted decrease
// -(g.y + 0.5 y.B y).
//
// Every operation is the plain version's, in its order, rounded once as
// PyTorch's elementwise kernels round it: the _rn intrinsics keep nvcc from
// fusing a product and a sum into an FMA, the clamps and maxima propagate
// NaN as PyTorch's do, and the minimum of the four candidates is the first
// lowest (a NaN first). So the kernel equals its plain version on the card
// bit for bit, in float32 and float64.
//
// What bounds it on an H100: latency. B windows move 9 values each (6 read,
// 3 written: 72 bytes in float64); what takes the time is one window's
// chain of dependent operations, and above all the bisection's: each step
// needs the previous step's interval, and each takes two divisions. The chain
// of the design below is counted, and its operations' latencies measured,
// in apps/probe_op_latency.py (csrc/op_chain.cu).
//
// Design: one warp a window (kWarps windows a block), so B = 15 windows run
// side by side as B = 2 do. Every lane computes the eigenbasis, the bracket
// and, after the bisection, the four candidates, the same values in
// lockstep; lane 0 writes. The 64-step bisection runs in 13 rounds of 5
// levels (the last of 4: 64 = 12 x 5 + 4). In a round, lane l < 31 takes
// node l (heap order) of the complete binary tree of the next 5 steps from
// the current (lo, hi): it computes its node's interval by repeating, along
// the path from the root, the sequential step's own updates (mid = 0.5 (lo +
// hi); lo = mid to the right, hi = mid to the left), then its node's mid and
// the test too_big(mid) with its two divisions. __ballot_sync gathers the
// 31 answers; every lane walks the levels from the root by the ballot's bits
// to the last level's node, and takes that node's interval and mid from the
// lane that computed them (__shfl_sync): the last step gives the new
// (lo, hi). A node on the walked path holds the sequential loop's interval
// at that step, computed by the same operations on the same values, so the
// round ends on the sequential loop's (lo, hi), bit for bit. One round's
// chain is 4 path steps, the mid, one test (one division deep), a ballot, a
// few integer steps and a shuffle: 13 divisions deep where the loop was 64.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // windows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBisections = 64;
constexpr int kLevels = 5;  // bisection steps a round: 31 tree nodes, one a lane

template <typename T>
struct R;

template <>
struct R<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
};

template <>
struct R<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
};

// torch.clamp(v, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : R<T>::max(v, lo);
}

// torch.maximum(a, b): either NaN propagates
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : R<T>::max(a, b));
}

// B00 y0^2 + 2 B01 y0 y1 + B11 y1^2, summed left to right
template <typename T>
__device__ __forceinline__ T quad(T B00, T B01, T B11, T y0, T y1) {
  using r = R<T>;
  const T a = r::mul(r::mul(B00, y0), y0);
  const T b = r::mul(r::mul(r::mul(T(2), B01), y0), y1);
  const T c = r::mul(r::mul(B11, y1), y1);
  return r::add(r::add(a, b), c);
}

// 0.5 quad + (g0 y0 + g1 y1)
template <typename T>
__device__ __forceinline__ T model_value(T B00, T B01, T B11, T g0, T g1, T y0, T y1) {
  using r = R<T>;
  return r::add(r::mul(T(0.5), quad(B00, B01, B11, y0, y1)),
                r::add(r::mul(g0, y0), r::mul(g1, y1)));
}

// The sequential step's test: whether |y(mid)| > r.
template <typename T>
__device__ __forceinline__ bool too_big(T mid, T e1, T e2, T ngh1, T ngh2, T rr) {
  using r = R<T>;
  const T tiny = T(1e-30);
  const T y1 = r::div(ngh1, clamp_min(r::add(e1, mid), tiny));
  const T y2 = r::div(ngh2, clamp_min(r::add(e2, mid), tiny));
  return r::add(r::mul(y1, y1), r::mul(y2, y2)) > rr;
}

// The plain version's 64 steps
//   mid = 0.5 (lo + hi); lo = too_big(mid) ? mid : lo; hi = too_big(mid) ? hi : mid
// as 13 rounds of a warp (see the header): (lo, hi) in every lane on entry
// and on return, the same values in every lane.
template <typename T>
__device__ __forceinline__ void bisect(T& lo, T& hi, T e1, T e2, T ngh1, T ngh2, T rr,
                                       int lane) {
  using r = R<T>;
  const unsigned path = lane + 1;  // heap node lane, plus one: a leading one, then the path
  const int depth = 31 - __clz(path);
#pragma unroll 1
  for (int done = 0; done < kBisections; done += kLevels) {
    const int levels = kBisections - done < kLevels ? kBisections - done : kLevels;
    T a = lo, b = hi;  // this lane's node's interval: the steps along its path
#pragma unroll
    for (int j = kLevels - 2; j >= 0; --j) {
      const T mid = r::mul(T(0.5), r::add(a, b));
      const bool step = j < depth, right = (path >> j) & 1u;
      a = step && right ? mid : a;
      b = step && !right ? mid : b;
    }
    const T mid = r::mul(T(0.5), r::add(a, b));
    const unsigned bits = __ballot_sync(0xffffffffu, too_big(mid, e1, e2, ngh1, ngh2, rr));
    int node = 0;
    for (int k = 1; k < levels; ++k) node = 2 * node + 1 + static_cast<int>((bits >> node) & 1u);
    const T na = __shfl_sync(0xffffffffu, a, node);
    const T nb = __shfl_sync(0xffffffffu, b, node);
    const T nm = __shfl_sync(0xffffffffu, mid, node);
    const bool up = (bits >> node) & 1u;
    lo = up ? nm : na;
    hi = up ? nb : nm;
  }
}

template <typename T>
__device__ void boundary_min(T B00, T B01, T B11, T g0, T g1, T rad, int lane, T* out0,
                             T* out1) {
  using r = R<T>;
  const T tiny = T(1e-30);
  const T mean = r::mul(T(0.5), r::add(B00, B11));
  const T half = r::mul(T(0.5), r::sub(B00, B11));
  const T d = r::sqrt(r::add(r::mul(half, half), r::mul(B01, B01)));
  const T e1 = r::sub(mean, d);
  const T e2 = r::add(mean, d);
  const bool use_a = fabs(r::sub(e1, B00)) > fabs(r::sub(e1, B11));
  const T w0 = use_a ? B01 : r::sub(e1, B11);
  const T w1 = use_a ? r::sub(e1, B00) : B01;
  const T n1 = r::sqrt(r::add(r::mul(w0, w0), r::mul(w1, w1)));
  const T n1_safe = clamp_min(n1, tiny);
  const bool big = n1 > tiny;
  const T v10 = big ? r::div(w0, n1_safe) : T(1);
  const T v11 = big ? r::div(w1, n1_safe) : T(0);
  const T v20 = -v11, v21 = v10;
  const T gh1 = r::add(r::mul(v10, g0), r::mul(v11, g1));
  const T gh2 = r::add(r::mul(v20, g0), r::mul(v21, g1));
  const T ngh1 = -gh1, ngh2 = -gh2;

  const T gnorm = r::sqrt(r::add(r::mul(gh1, gh1), r::mul(gh2, gh2)));
  T lo = clamp_min(-e1, T(0));
  T hi = maximum(r::add(lo, tiny), r::add(-e1, r::div(gnorm, clamp_min(rad, tiny))));
  const T rr = r::mul(rad, rad);
  bisect(lo, hi, e1, e2, ngh1, ngh2, rr, lane);
  const T lam = r::mul(T(0.5), r::add(lo, hi));
  T yh1 = r::div(ngh1, clamp_min(r::add(e1, lam), tiny));
  T yh2 = r::div(ngh2, clamp_min(r::add(e2, lam), tiny));
  const T tau =
      r::sqrt(clamp_min(r::sub(rr, r::add(r::mul(yh1, yh1), r::mul(yh2, yh2))), T(0)));
  yh1 = r::add(yh1, gh1 > T(0) ? -tau : tau);
  const T scale =
      r::div(rad, clamp_min(r::sqrt(r::add(r::mul(yh1, yh1), r::mul(yh2, yh2))), tiny));
  yh1 = r::mul(yh1, scale);
  yh2 = r::mul(yh2, scale);

  const T gg = clamp_min(r::sqrt(r::add(r::mul(g0, g0), r::mul(g1, g1))), tiny);
  const T nr = -rad;
  const T c0[4] = {r::add(r::mul(yh1, v10), r::mul(yh2, v20)), r::div(r::mul(nr, g0), gg),
                   r::mul(rad, v10), r::mul(nr, v10)};
  const T c1[4] = {r::add(r::mul(yh1, v11), r::mul(yh2, v21)), r::div(r::mul(nr, g1), gg),
                   r::mul(rad, v11), r::mul(nr, v11)};
  T y0 = c0[0], y1 = c1[0];
  T best = model_value(B00, B01, B11, g0, g1, y0, y1);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const T v = model_value(B00, B01, B11, g0, g1, c0[i], c1[i]);
    const bool take = (v < best) || (v != v && best == best);
    y0 = take ? c0[i] : y0;
    y1 = take ? c1[i] : y1;
    best = take ? v : best;
  }
  *out0 = y0;
  *out1 = y1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    subspace_step_kernel(const T* __restrict__ model, const T* __restrict__ radius,
                                     T* __restrict__ out, int B) {
  using r = R<T>;
  const int b = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (b >= B) return;  // the whole warp: the ballots below see all 32 lanes
  const T B00 = model[5 * b], B01 = model[5 * b + 1], B11 = model[5 * b + 2];
  const T g0 = model[5 * b + 3], g1 = model[5 * b + 4];
  const T rad = radius[b];
  const T det = r::sub(r::mul(B00, B11), r::mul(B01, B01));
  const bool posdef = (B00 > T(0)) && (det > T(0));
  const T det_safe = det == T(0) ? T(1) : det;
  const T yi0 = r::div(r::add(r::mul(-g0, B11), r::mul(g1, B01)), det_safe);
  const T yi1 = r::div(r::add(r::mul(-g1, B00), r::mul(g0, B01)), det_safe);
  const bool interior =
      posdef && (r::add(r::mul(yi0, yi0), r::mul(yi1, yi1)) <= r::mul(rad, rad));
  T yb0, yb1;
  boundary_min(B00, B01, B11, g0, g1, rad, lane, &yb0, &yb1);
  const T y0 = interior ? yi0 : yb0;
  const T y1 = interior ? yi1 : yb1;
  const T lin = r::add(r::mul(g0, y0), r::mul(g1, y1));
  const T pred = -r::add(lin, r::mul(T(0.5), quad(B00, B01, B11, y0, y1)));
  if (lane == 0) {
    out[3 * b] = y0;
    out[3 * b + 1] = y1;
    out[3 * b + 2] = pred;
  }
}

template <typename T>
int launch(const void* model, const void* radius, void* out, int B, int device, int multi_device,
           void* stream) {
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B < 1) return 0;
  subspace_step_kernel<T><<<(B + kWarps - 1) / kWarps, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(model), static_cast<const T*>(radius), static_cast<T*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// model [B, 5], radius [B], out [B, 3]: contiguous on `device`. Returns
// cudaGetLastError() of the launch.
extern "C" int subspace_step_f32(const void* model, const void* radius, void* out, int B,
                                 int device, int multi_device, void* stream) {
  return launch<float>(model, radius, out, B, device, multi_device, stream);
}

extern "C" int subspace_step_f64(const void* model, const void* radius, void* out, int B,
                                 int device, int multi_device, void* stream) {
  return launch<double>(model, radius, out, B, device, multi_device, stream);
}
