// Latencies of the operations on the subspace_step kernel's dependent chain
// (csrc/subspace_step.cu), for Hopper (sm_90a). Not on any solve's path:
// apps/probe_op_latency.py builds and times it, and turns the latencies
// into that kernel's latency bound.
//
// One warp runs a chain of n dependent operations of one kind from seed
// (0 add, 1 mul, 2 division, 3 square root, 4 a round's exchange: the
// ballot, the walk of `levels` levels and the shuffle, then an add of a
// lane's own term, as a lane's path steps follow the shuffle in a round)
// and writes where it ends. Each operation is rounded as subspace_step's
// are (the _rn intrinsics: no FMA contraction). The caller times a chain of
// n and one of 0 between CUDA events: the difference is the chain's own
// time. The values differ from lane to lane, as the kernel's intervals do:
// a shuffle of a value the compiler can prove the same in every lane is
// that value, and the exchange's chain would vanish.

#include <cuda_runtime.h>

namespace {

template <typename T>
struct R;

template <>
struct R<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct R<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

template <typename T, typename Op>
__device__ __forceinline__ T chain(T x, int n, Op op) {
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = op(x);
  return x;
}

template <typename T>
__global__ void op_chain_kernel(const T* __restrict__ seed, T* __restrict__ out, int kind,
                                int n, int levels) {
  using r = R<T>;
  const int lane = threadIdx.x;
  const T y = seed[1];  // 1 + 2^-20: the chains stay normal numbers
  const T own = r::mul(T(lane), r::sub(y, T(1)));
  T x = r::add(seed[0], own);
  if (kind == 0) x = chain(x, n, [&](T v) { return r::add(v, y); });
  if (kind == 1) x = chain(x, n, [&](T v) { return r::mul(v, y); });
  if (kind == 2) x = chain(x, n, [&](T v) { return r::div(v, y); });
  if (kind == 3) x = chain(x, n, [&](T v) { return r::sqrt(v); });
  if (kind == 4) {
    x = chain(x, n, [&](T v) {
      const unsigned bits = __ballot_sync(0xffffffffu, (v > T(0)) == static_cast<bool>(lane & 1));
      int node = 0;
      for (int k = 1; k < levels; ++k) node = 2 * node + 1 + static_cast<int>((bits >> node) & 1u);
      return r::add(__shfl_sync(0xffffffffu, v, node), own);
    });
  }
  out[lane] = x;
}

template <typename T>
int launch(const void* seed, void* out, int kind, int n, int levels, int device, int multi_device,
           void* stream) {
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  op_chain_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(seed), static_cast<T*>(out), kind, n, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seed [2] (x0, y) and out [32] of the chain's type on `device`; one warp, a
// chain of n operations of `kind`, a round's walk `levels` levels deep.
// Returns cudaGetLastError() of the launch.
extern "C" int op_chain_f32(const void* seed, void* out, int kind, int n, int levels, int device,
                            int multi_device, void* stream) {
  return launch<float>(seed, out, kind, n, levels, device, multi_device, stream);
}

extern "C" int op_chain_f64(const void* seed, void* out, int kind, int n, int levels, int device,
                            int multi_device, void* stream) {
  return launch<double>(seed, out, kind, n, levels, device, multi_device, stream);
}
