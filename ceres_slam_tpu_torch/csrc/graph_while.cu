// A device-side while loop for Hopper, sm_90a: a CUDA graph whose
// conditional WHILE node runs a captured body until a predicate on the
// device is false, with no host work between iterations; the body may hold
// while loops of its own, as nested WHILE nodes.
//
// The counterpart of jax.lax.while_loop on the TPU, which runs a compiled
// body (with Pallas kernels in it: K3 inside pcg_solve's loop,
// ceres_slam_tpu/solver/pcg.py, itself inside lm_solve's loop,
// ceres_slam_tpu/solver/lm.py; the probe's grid_in_while case,
// scripts/probe_pallas_scan.py) until a condition computed on the device
// turns false. Here the body is a sequence of CUDA graphs that PyTorch
// captured (torch.cuda.CUDAGraph(keep_graph=True), raw_cuda_graph()), and
// each predicate an int32 on the device that a body writes.
//
// The graph built here, for segments s_0 .. s_{n-1}, each a plain segment
// or an inner loop with its own predicate:
//
//   enter (kernel: counts = 0; ns = 0; stamp the start; condition = pred != 0)
//     -> WHILE node [ s_0 -> s_1 -> ... -> s_{n-1}
//                     -> next (kernel: counts[0] += 1; condition = pred != 0;
//                              once it is 0, ns[0] += now - start) ]
//
// where a plain segment is a child graph node (the capture) and an inner
// loop k is
//
//   enter_inner (kernel: stamp inner loop k's start; condition_k = pred_k != 0)
//     -> WHILE node [ child graph (the capture)
//                     -> next_inner (kernel: counts[1 + k] += 1;
//                                    condition_k = pred_k != 0; once it is 0,
//                                    ns[1 + k] += now - inner start) ]
//
// so every loop may run zero times, as lax.while_loop may, and counts[1 +
// k] sums inner loop k's iterations over the whole run. The device timers
// ride in those kernels (no node of their own): ns[0] is the node's
// nanoseconds on the device's global timer (%globaltimer), from its entry
// to its last test, and ns[1 + k] inner loop k's, from each entry to its
// last test, summed over the run; a loop that runs zero times adds nothing.
// ns holds 2 * num_counts int64: the sums, then each loop's start stamp
// (the outer loop's, then inner loop k's at num_counts + 1 + k). A segment that holds
// a node type a conditional body cannot hold (a host node, an event record
// or wait: what a library may add to a capture) is refused, naming the
// segment and the type, before anything is built; graph_node_types lists a
// captured graph's node types. The child graph
// nodes clone the captured graphs; the caller keeps the memory they read
// and write (PyTorch's graph pool) alive as long as the executable graph.
//
// What bounds it on an H100: the graph launch (one host call for the whole
// loop) and, per iteration, the bodies' own kernels plus the conditionals'
// re-launch of their bodies on the device; the small kernels move a few
// bytes and read the global timer.
// Conditional nodes need CUDA 12.3 or newer, in the toolkit and the driver;
// a conditional node inside a conditional body (the nested loop) is listed
// among the node types a body may hold in CUDA 12.9's headers
// (cudaConditionalNodeParams, driver_types.h), and ops/graph_loop.py asks
// for 12.4 or newer before it builds one.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12030
#error "conditional graph nodes need CUDA 12.3 or newer"
#endif

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void loop_enter(cudaGraphConditionalHandle handle, const int* pred, int* counts,
                           long long* ns, int num_counts) {
  for (int i = 0; i < num_counts; ++i) {
    counts[i] = 0;
    ns[i] = 0;
  }
  ns[num_counts] = global_ns();
  cudaGraphSetConditional(handle, *pred != 0);
}

// The condition of a loop from its predicate. With a count (a loop's test
// after an iteration): the count of the iteration that just ran first, and
// once the predicate is 0, the time since the loop's start stamp (*start)
// added to *ns. Without one (an inner loop's entry): the start stamped.
__global__ void loop_test(cudaGraphConditionalHandle handle, const int* pred, int* count,
                          long long* start, long long* ns) {
  const bool go = *pred != 0;
  if (count) {
    *count += 1;
    if (!go) *ns += global_ns() - *start;
  } else {
    *start = global_ns();
  }
  cudaGraphSetConditional(handle, go);
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

// A WHILE node on `handle` in `graph` after `dep` (none if null); its body
// graph in *body.
cudaError_t add_while(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                      cudaGraphConditionalHandle handle, cudaGraph_t* body) {
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  const size_t num_deps = dep ? 1 : 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphAddNode(node, graph, dep, nullptr, num_deps, &cp);
#else
  cudaError_t err = cudaGraphAddNode(node, graph, dep, num_deps, &cp);
#endif
  if (err == cudaSuccess) *body = cp.conditional.phGraph_out[0];
  return err;
}

// `loop_test(handle, pred, count, start, ns)` as a kernel node after `dep`.
cudaError_t add_test(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                     cudaGraphConditionalHandle handle, const int* pred, int* count,
                     long long* start, long long* ns) {
  void* args[] = {&handle, &pred, &count, &start, &ns};  // copied into the node
  return add_kernel(node, graph, dep, dep ? 1 : 0, reinterpret_cast<void*>(loop_test), args);
}

#define CHECK(x)                              \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// The node types a conditional body may hold (CUDA's programming guide,
// "Conditional Graph Nodes": kernels, empty nodes, memcpy and memset nodes,
// child graphs and conditional nodes). A captured segment that holds another
// type (a host node, an event record or wait, a memory allocation, a batch
// memory operation) cannot run in a WHILE node's body.
bool allowed_in_body(cudaGraphNodeType t) {
  return t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemcpy ||
         t == cudaGraphNodeTypeMemset || t == cudaGraphNodeTypeEmpty ||
         t == cudaGraphNodeTypeGraph || t == cudaGraphNodeTypeConditional;
}

// Appends the type of every node of `graph`, child graphs' nodes after
// their child graph node, to types[*count..max) (counting past max).
cudaError_t collect_types(cudaGraph_t graph, int* types, int max, int* count) {
  size_t n = 0;
  CHECK(cudaGraphGetNodes(graph, nullptr, &n));
  if (n == 0) return cudaSuccess;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  cudaError_t err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    if (*count < max) types[*count] = static_cast<int>(t);
    ++*count;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = collect_types(child, types, max, count);
    }
  }
  delete[] nodes;
  return err;
}

// The first node type of `graph` a conditional body cannot hold, or -1.
cudaError_t refused_type(cudaGraph_t graph, int* type) {
  constexpr int kMax = 1 << 16;
  int* types = new int[kMax];
  int count = 0;
  const cudaError_t err = collect_types(graph, types, kMax, &count);
  *type = -1;
  for (int i = 0; err == cudaSuccess && i < count && i < kMax; ++i) {
    if (!allowed_in_body(static_cast<cudaGraphNodeType>(types[i]))) {
      *type = types[i];
      break;
    }
  }
  delete[] types;
  return err;
}

// The loop around segments[0..n): preds[i] null for a plain segment, else
// the predicate of inner loop k (k counts the inner loops in order), whose
// iterations go to counts[1 + k] and its nanoseconds to ns[1 + k]. A
// segment holding a node type a conditional body cannot hold is refused
// (cudaErrorNotSupported), its index and that type in refused[0..2).
cudaError_t build(Loop* loop, cudaGraph_t* segments, const int* const* preds, int n,
                  const int* pred, int* counts, long long* ns, int num_counts, int* refused) {
  for (int i = 0; i < n; ++i) {
    int type;
    CHECK(refused_type(segments[i], &type));
    if (type >= 0) {
      refused[0] = i;
      refused[1] = type;
      return cudaErrorNotSupported;
    }
  }
  CHECK(cudaGraphCreate(&loop->graph, 0));
  cudaGraphConditionalHandle handle;
  CHECK(cudaGraphConditionalHandleCreate(&handle, loop->graph, 0, 0));
  void* args[] = {&handle, &pred, &counts, &ns, &num_counts};
  cudaGraphNode_t enter, cond;
  CHECK(add_kernel(&enter, loop->graph, nullptr, 0, reinterpret_cast<void*>(loop_enter), args));
  cudaGraph_t body;
  CHECK(add_while(&cond, loop->graph, &enter, handle, &body));
  cudaGraphNode_t prev = nullptr;  // the body's last node so far
  int k = 0;
  for (int i = 0; i < n; ++i) {
    const cudaGraphNode_t dep = prev;
    const cudaGraphNode_t* deps = dep ? &dep : nullptr;
    if (!preds[i]) {
      size_t num_nodes = 0;  // a plain segment that captured nothing is left out
      CHECK(cudaGraphGetNodes(segments[i], nullptr, &num_nodes));
      if (num_nodes) CHECK(cudaGraphAddChildGraphNode(&prev, body, deps, dep ? 1 : 0, segments[i]));
      continue;
    }
    cudaGraphConditionalHandle inner;
    CHECK(cudaGraphConditionalHandleCreate(&inner, body, 0, 0));
    cudaGraphNode_t inner_enter, child, inner_next;
    long long* start = ns + num_counts + 1 + k;
    CHECK(add_test(&inner_enter, body, deps, inner, preds[i], nullptr, start, nullptr));
    cudaGraph_t inner_body;
    CHECK(add_while(&prev, body, &inner_enter, inner, &inner_body));
    CHECK(cudaGraphAddChildGraphNode(&child, inner_body, nullptr, 0, segments[i]));
    CHECK(add_test(&inner_next, inner_body, &child, inner, preds[i], counts + 1 + k, start,
                   ns + 1 + k));
    ++k;
  }
  const cudaGraphNode_t dep = prev;
  cudaGraphNode_t next;
  CHECK(add_test(&next, body, dep ? &dep : nullptr, handle, pred, counts, ns + num_counts, ns));
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

// Builds and instantiates the loop around the body segments[0..n) (each a
// cudaGraph_t, cloned into the loop); preds[i]: null for a plain segment,
// else the int32 predicate of an inner loop whose body is segments[i];
// pred: the loop's predicate; counts: num_counts = 1 + (number of inner
// loops) int32; ns: 2 * num_counts int64; all on `device`. The loop runs
// the body while *pred != 0, checked before every iteration, and leaves its
// iterations in counts[0] and inner loop k's, summed over the run, in
// counts[1 + k]; their device nanoseconds likewise in ns[0] and ns[1 + k]
// (ns[num_counts..] holds the start stamps). Writes the loop's
// handle to *out; returns a CUDA error code (nothing is left allocated on
// error). A segment that holds a node a conditional body cannot hold (a host
// node, an event record or wait, ...) is refused with cudaErrorNotSupported,
// its index and the node's cudaGraphNodeType in refused[0] and refused[1].
extern "C" int graph_while_create(void** segments, void** preds, int n, const void* pred,
                                  void* counts, void* ns, int num_counts, int device,
                                  int multi_device, int* refused, void** out) {
  *out = nullptr;
  refused[0] = refused[1] = -1;
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Loop* loop = new Loop;
  const cudaError_t err = build(loop, reinterpret_cast<cudaGraph_t*>(segments),
                                reinterpret_cast<const int* const*>(preds), n,
                                static_cast<const int*>(pred), static_cast<int*>(counts),
                                static_cast<long long*>(ns), num_counts, refused);
  if (err != cudaSuccess) {
    destroy(loop);
    return static_cast<int>(err);
  }
  *out = loop;
  return 0;
}

// The cudaGraphNodeType of every node of `graph` (a cudaGraph_t), child
// graphs' nodes after their child graph node, in types[0..max); their number
// in *count (which may exceed max).
extern "C" int graph_node_types(void* graph, int* types, int max, int* count) {
  *count = 0;
  return static_cast<int>(collect_types(static_cast<cudaGraph_t>(graph), types, max, count));
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
