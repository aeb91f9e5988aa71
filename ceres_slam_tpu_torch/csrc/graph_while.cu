// A device-side while loop for Hopper, sm_90a: a CUDA graph whose
// conditional WHILE node runs a captured body until a predicate on the
// device is false, with no host work between iterations.
//
// The counterpart of jax.lax.while_loop on the TPU, which runs a compiled
// body (with Pallas kernels in it: K3 inside pcg_solve's loop,
// ceres_slam_tpu/solver/pcg.py, and the probe's grid_in_while case,
// scripts/probe_pallas_scan.py) until a condition computed on the device
// turns false. Here the body is a CUDA graph that PyTorch captured
// (torch.cuda.CUDAGraph(keep_graph=True), raw_cuda_graph()), and the
// predicate an int32 on the device that the body writes.
//
// The graph built here:
//
//   enter (kernel: count = 0; condition = pred != 0)
//     -> WHILE node [ body (child graph: PyTorch's capture)
//                     -> next (kernel: count += 1; condition = pred != 0) ]
//
// so the loop may run zero times, as lax.while_loop may. The child graph
// node clones the captured graph; the caller keeps the memory it reads and
// writes (PyTorch's graph pool) alive as long as the executable graph.
//
// What bounds it on an H100: the graph launch (one host call for the whole
// loop) and, per iteration, the body's own kernels plus the conditional's
// re-launch of the body on the device; the two small kernels move 8 bytes.
// Conditional nodes need CUDA 12.3 or newer, in the toolkit and the driver.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12030
#error "conditional graph nodes need CUDA 12.3 or newer"
#endif

namespace {

__global__ void loop_enter(cudaGraphConditionalHandle handle, const int* pred, int* count) {
  *count = 0;
  cudaGraphSetConditional(handle, *pred != 0);
}

__global__ void loop_next(cudaGraphConditionalHandle handle, const int* pred, int* count) {
  *count += 1;
  cudaGraphSetConditional(handle, *pred != 0);
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                       size_t num_deps, void* fn, void** args) {
  cudaKernelNodeParams p = {};
  p.func = fn;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, deps, num_deps, &p);
}

cudaError_t build(Loop* loop, cudaGraph_t body, const int* pred, int* count) {
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, loop->graph, 0, 0);
  if (err != cudaSuccess) return err;
  void* args[] = {&handle, &pred, &count};  // copied into the nodes when they are added
  cudaGraphNode_t enter, cond, child, next;
  err = add_kernel(&enter, loop->graph, nullptr, 0, reinterpret_cast<void*>(loop_enter), args);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&cond, loop->graph, &enter, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(&cond, loop->graph, &enter, 1, &cp);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  err = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body);
  if (err != cudaSuccess) return err;
  err = add_kernel(&next, inner, &child, 1, reinterpret_cast<void*>(loop_next), args);
  if (err != cudaSuccess) return err;
  return cudaGraphInstantiate(&loop->exec, loop->graph, 0);
}

void destroy(Loop* loop) {
  if (loop->exec) cudaGraphExecDestroy(loop->exec);
  if (loop->graph) cudaGraphDestroy(loop->graph);
  delete loop;
}

}  // namespace

// The CUDA runtime this library was built with and the driver's version
// (as 1000 * major + 10 * minor).
extern "C" int graph_while_versions(int* runtime, int* driver) {
  const cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDriverGetVersion(driver));
}

// Builds and instantiates the loop around `body` (a cudaGraph_t, cloned
// into the WHILE node); pred and count: one int32 each on `device`. The
// loop runs the body while *pred != 0, checked before every iteration, and
// leaves the number of iterations in *count. Writes the loop's handle to
// *out; returns a CUDA error code (nothing is left allocated on error).
extern "C" int graph_while_create(void* body, const void* pred, void* count, int device,
                                  int multi_device, void** out) {
  *out = nullptr;
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Loop* loop = new Loop;
  const cudaError_t err = build(loop, static_cast<cudaGraph_t>(body),
                                static_cast<const int*>(pred), static_cast<int*>(count));
  if (err != cudaSuccess) {
    destroy(loop);
    return static_cast<int>(err);
  }
  *out = loop;
  return 0;
}

// Enqueues the whole loop on `stream`: one host call, however many
// iterations the device runs.
extern "C" int graph_while_launch(void* loop, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<Loop*>(loop)->exec, static_cast<cudaStream_t>(stream)));
}

// Frees the executable and the graph (a launch in flight finishes first).
extern "C" int graph_while_destroy(void* loop) {
  destroy(static_cast<Loop*>(loop));
  return 0;
}
