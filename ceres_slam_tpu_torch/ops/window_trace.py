"""Where K1's device time goes: a per-phase clock trace of one call.

    python -m ceres_slam_tpu_torch.ops.window_trace      # on a CUDA card

Builds an instrumented copy of ``csrc/window_factor_blocks.cu`` (thread 0
of every block writes ``clock64()`` at phase boundaries, and
``%globaltimer`` at its start and end, into a device array), runs it at
the flagship window shape (K=2, J=192, O=2) and the S scale (K=64, J=2048,
O=8) in float64 and float32 on ``random_inputs``, and prints, beside
torch.profiler's device time per call of the uninstrumented kernel, the
cycles of each phase for the first pose and landmark blocks and the last
of each: a pose block's loads and arithmetic, its reductions, the ticket's
round trip and the last block's sum of the costs; a landmark block's
loads, arithmetic and sums. The copy is made by inserting lines at fixed
anchors of the source; an anchor that is gone fails the run.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import cuda_build, window_kernel

_STAMPS = (  # (anchor, text inserted after it)
    ("#include <cuda_runtime.h>\n",
     "__device__ unsigned long long g_trace[4096][10];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t;\n"
     "}\n#define STAMP(i) if (threadIdx.x == 0) g_trace[blockIdx.x][i] = clock64();\n"),
    ("    accumulate(Jp, rw, acc);\n    }\n  }\n", "  STAMP(2)\n"),
    ("  for (int r = 0; r < kRed; ++r) red[r * kPitch + tid] = acc[r];\n  __syncthreads();\n",
     "  STAMP(3)\n"),
    ('  asm volatile("bar.sync 1, %0;" ::"n"(kWorkers));\n', "  STAMP(4)\n"),
    ("      hppgp[k * kRows + kRows - 1] = x;\n", "      g_trace[blockIdx.x][5] = clock64();\n"),
    ("      prev = ticket.fetch_add(1u, cuda::memory_order_acq_rel);\n",
     "      g_trace[blockIdx.x][6] = clock64() + 0 * prev;\n"),
    ("        *g.ticket = 0u;\n", "        g_trace[blockIdx.x][9] = clock64();\n"),
    ("  for (int i = tid; i < 12 * g.K; i += kThreads) pose_s[i] = __ldg(poses + i);\n"
     "  __syncthreads();\n", "  STAMP(2)\n"),
    ("          um[3 * a + c] = Jp[0][a] * Jl[0][c] + Jp[1][a] * Jl[1][c] + Jp[2][a] * Jl[2][c];\n"
     "    } else {\n#pragma unroll\n      for (int r = 0; r < 18; ++r) um[r] = T(0);\n    }\n  }\n",
     "  STAMP(3)\n"),
    ("  for (int r = 0; r < kLmRows; ++r) stage[r * kPitch + tid] = h[r];\n  __syncthreads();\n",
     "  STAMP(4)\n"),
    ("  const Cam<T> cam{T(g.fu), T(g.fv), T(g.cu), T(g.cv), T(g.fb)};\n",
     "  if (threadIdx.x == 0) {\n    g_trace[blockIdx.x][0] = gtime();\n"
     "    g_trace[blockIdx.x][1] = clock64();\n    g_trace[blockIdx.x][9] = 0;\n  }\n"),
    ("                      smem + kLmRows * kPitch);\n  }\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) {\n    g_trace[blockIdx.x][7] = clock64();\n"
     "    g_trace[blockIdx.x][8] = gtime();\n  }\n"),
    ('extern "C" {\n',
     "int read_trace(void* dst) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));\n}\n"),
)


def instrumented_source() -> str:
    src = (cuda_build.CSRC / "window_factor_blocks.cu").read_text()
    for anchor, text in _STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the K1 source: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    return src


def _library() -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / "window_trace.cu"
    so = cuda_build.BUILD_DIR / "window_trace.so"
    cu.write_text(instrumented_source())
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    for name in ("window_factor_blocks_f32", "window_factor_blocks_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(window_kernel._Args), p, p, p, p]
        fn.restype = ctypes.c_int
    lib.read_trace.argtypes = [p]
    lib.read_trace.restype = ctypes.c_int
    return lib


def _device_us(call, reps=20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps


def trace(lib, K, J, O, dtype):
    plan, poses, points = window_kernel.random_inputs(K, J, O, dtype, "cuda", seed=7)
    M = J * O
    out = torch.empty(M * 18 + J * 12 + K * 43 + 1, dtype=dtype, device="cuda")
    name = "window_factor_blocks_f64" if dtype == torch.float64 else "window_factor_blocks_f32"
    traced = getattr(lib, name)
    plain = lambda: window_kernel.window_factor_blocks(plan, poses, points)  # noqa: E731
    device_us = _device_us(plain)
    err = traced(plan.args, poses.data_ptr(), points.data_ptr(), out.data_ptr(),
                 cuda_build.current_stream(0))
    if err:
        raise cuda_build.launch_error(err, "window_trace")
    torch.cuda.synchronize()
    buf = np.zeros((4096, 10), np.uint64)
    if lib.read_trace(buf.ctypes.data) != 0:
        raise RuntimeError("reading the trace failed")
    L = 64 // O if O <= 64 else 1
    blocks = K + (J + L - 1) // L
    t = buf[:blocks].astype(np.int64)
    t0 = t[:, 0].min()
    print(f"== K1 K={K} J={J} O={O} {dtype}: {blocks} blocks, device {device_us:.2f} us per call "
          f"(torch.profiler, uninstrumented); all blocks ended {(t[:, 8] - t0).max()} ns after "
          "the first began")
    print("  pose block k: start ns | cycles: loads+math, stage+sync, parts+barrier, "
          "cost reduce, ticket, last sum | total")
    for b in sorted({0, 1, K - 1} & set(range(K))):
        r = t[b]
        last = r[9] - r[6] if r[9] else 0
        print(f"    {b:4d}: {r[0] - t0:6d} | {r[2] - r[1]:6d} {r[3] - r[2]:6d} {r[4] - r[3]:6d} "
              f"{r[5] - r[3]:6d} {r[6] - r[5]:6d} {last:6d} | {r[7] - r[1]:6d}")
    print("  landmark block b: start ns | cycles: loads+pose staging, math+u, stage+sync, "
          "sums | total")
    for b in sorted({K, K + 1, blocks - 1} & set(range(K, blocks))):
        r = t[b]
        print(f"    {b - K:4d}: {r[0] - t0:6d} | {r[2] - r[1]:6d} {r[3] - r[2]:6d} {r[4] - r[3]:6d} "
              f"{r[7] - r[4]:6d} | {r[7] - r[1]:6d}")


def main():
    if not torch.cuda.is_available():
        sys.exit("window_trace needs a CUDA device")
    lib = _library()
    for K, J, O in ((2, 192, 2), (64, 2048, 8)):
        for dtype in (torch.float64, torch.float32):
            trace(lib, K, J, O, dtype)


if __name__ == "__main__":
    main()
