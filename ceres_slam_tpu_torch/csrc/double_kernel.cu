// o = 2 x on a float32 array (P) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel double_kernel of
// scripts/probe_pallas_scan.py, which computes o = 2 x on a [2, 512]
// float32 array inside a compiled loop: it probes whether a kernel can run
// inside lax.scan or lax.while_loop on the TPU toolchain. On Hopper the
// same question is whether a launch can be captured in a CUDA graph and
// replayed (ceres_slam_tpu_torch/apps/probe_graph_loop.py), which a
// launch-light solver loop needs.
//
// Two launch forms mirror the TPU probe's grid=(4,) and grid=(1,): 4 blocks
// of 256 threads, one element a thread, and 1 block of 256 threads that
// loops over the array. The output may be the input (in place): each
// element is read before it is written, by the same thread.
//
// What bounds it on an H100: latency. It moves 8 KB (4 KB read, 4 KB
// written), 2.4 ns at 3.35 TB/s, and does 1,024 multiplications; a launch
// costs microseconds of host and device latency. Its design does nothing
// about that: the answer is to launch it fewer times (a CUDA graph).
// 2 x is exact in float32, so the kernel equals its plain version (x * 2)
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void double_grid(const float* x, float* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

__global__ void double_one_block(const float* x, float* o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i] * 2.0f;
}

}  // namespace

// x and o: n contiguous floats on `device` (o may be x). one_block selects
// the single-block form. Returns cudaGetLastError() of the launch.
extern "C" int double_kernel_f32(const void* x, void* o, int n, int one_block, int device,
                                 int multi_device, void* stream) {
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  if (one_block) {
    double_one_block<<<1, kThreads, 0, s>>>(xf, of, n);
  } else {
    double_grid<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(xf, of, n);
  }
  return static_cast<int>(cudaGetLastError());
}
