// An in-place all-reduce (sum) over the ranks of one host, for Hopper (sm_90a):
// every rank's process reads its peers' buffers directly, through CUDA IPC
// mappings (NVLink between cards, or one card's memory when processes share
// it), so the collective is one kernel that a CUDA graph can capture, also
// inside a conditional WHILE node's body.
//
// Not a port of a Pallas kernel: it replaces XLA's psum, which the JAX
// package's sharded solves run inside their compiled loops
// (ceres_slam_tpu/parallel/sharded_ba.py: the psums of make_sharded_blocks and
// make_sharded_cost; ceres_slam_tpu/parallel/sharded_pcg.py: the two psums of
// a CG iteration). The port's sharded loops run as WHILE nodes on the card
// (ops/graph_loop.py); this kernel is their all-reduce on the ranks of one
// host (parallel/sharded_ba.psum).
//
// The workspace of a rank (one cudaMalloc, exported with cudaIpcGetMemHandle
// and mapped by every peer once, before any loop):
//
//   slot   [slot_bytes]         this rank's copy of the buffer being reduced
//   ready  [kMaxBlocks][n] u32  ready[b][q] = e: rank q's chunk b of round e
//                               is in q's slot (written by q)
//   done   [kMaxBlocks][n] u32  done[b][q] = e: rank q has read chunk b of
//                               round e from every slot (written by q)
//   epoch  [kMaxBlocks]    u32  the rounds block b has run (this rank's own)
//
// A call: block b takes chunk b of the buffer, copies it into the rank's own
// slot, publishes epoch e = epoch[b] + 1 in ready[b][rank] of every rank
// (a system-scope release after a system-scope fence), waits until every
// peer's ready[b][q] in its own workspace reaches e, then sums the chunk over
// the slots in rank order 0..n-1 into the buffer, left to right. So every rank
// computes the same sums in the same order: the same bits on every rank, and
// no atomics (ROADMAP F14). A second round (done) keeps a slot from being
// overwritten before every peer has read it: block b returns only when every
// peer has read chunk b of this round, so when the kernel ends no peer reads
// this rank's slot any more, and the next call on the stream may overwrite it.
// The epochs live in device memory and the kernel advances them, so a graph
// replayed or a WHILE node restarted keeps counting; every rank makes the same
// calls in the same order with the same sizes, so block b's epochs agree
// across the ranks.
//
// Deadlock freedom: block b waits only for block b of its peers. The grid is
// at most kMaxBlocks (64) blocks of kThreads, far below what one H100 holds at
// once, so every block of a rank runs together; processes sharing one card
// take turns in time slices, and a waiting block gives way at the slice's end.
//
// What bounds it on an H100: the bytes each rank reads from its peers,
// (n - 1) x the buffer over NVLink's 450 GB/s each way, and for small buffers
// the latency of the two flag rounds (a few microseconds over NVLink).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 64;
constexpr int kMinChunk = 2048;  // elements a block takes before a second block is used

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Wait until flags[q] has reached e for every q < n (wrap-safe).
__device__ __forceinline__ void wait_all(const unsigned* flags, int n, unsigned e) {
  for (int q = 0; q < n; ++q) {
    while (static_cast<int>(load_acquire(flags + q) - e) < 0) {
    }
  }
}

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// Byte offsets of the workspace's parts after the slot.
__host__ __device__ inline size_t ready_offset(size_t slot_bytes) { return align256(slot_bytes); }
__host__ __device__ inline size_t done_offset(size_t slot_bytes, int n) {
  return ready_offset(slot_bytes) + align256(sizeof(unsigned) * kMaxBlocks * n);
}
__host__ __device__ inline size_t epoch_offset(size_t slot_bytes, int n) {
  return done_offset(slot_bytes, n) + align256(sizeof(unsigned) * kMaxBlocks * n);
}
inline size_t workspace_bytes(size_t slot_bytes, int n) {
  return epoch_offset(slot_bytes, n) + align256(sizeof(unsigned) * kMaxBlocks);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    peer_allreduce_kernel(T* __restrict__ x, long long numel, char* const* __restrict__ bases,
                          int rank, int n, long long slot_bytes) {
  const int b = blockIdx.x;
  const long long chunk = (numel + gridDim.x - 1) / gridDim.x;
  const long long lo = b * chunk;
  const long long hi = lo + chunk < numel ? lo + chunk : numel;
  char* const mine = bases[rank];
  unsigned* const my_ready = reinterpret_cast<unsigned*>(mine + ready_offset(slot_bytes)) + b * n;
  unsigned* const my_done = reinterpret_cast<unsigned*>(mine + done_offset(slot_bytes, n)) + b * n;
  unsigned* const my_epoch = reinterpret_cast<unsigned*>(mine + epoch_offset(slot_bytes, n)) + b;
  const unsigned e = *my_epoch + 1;  // only this block touches its epoch

  T* const slot = reinterpret_cast<T*>(mine);
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) slot[i] = x[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int q = 0; q < n; ++q) {
      unsigned* ready = reinterpret_cast<unsigned*>(bases[q] + ready_offset(slot_bytes));
      store_release(ready + b * n + rank, e);
    }
    wait_all(my_ready, n, e);
  }
  __syncthreads();
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    T acc = reinterpret_cast<const volatile T*>(bases[0])[i];
    for (int q = 1; q < n; ++q) acc += reinterpret_cast<const volatile T*>(bases[q])[i];
    x[i] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int q = 0; q < n; ++q) {
      unsigned* done = reinterpret_cast<unsigned*>(bases[q] + done_offset(slot_bytes, n));
      store_release(done + b * n + rank, e);
    }
    wait_all(my_done, n, e);
    *my_epoch = e;
  }
}

int blocks_for(long long numel) {
  const long long b = (numel + kMinChunk - 1) / kMinChunk;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename T>
int launch(void* x, long long numel, const void* bases, int rank, int n, long long slot_bytes,
           int device, int multi_device, void* stream) {
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (numel <= 0) return 0;
  peer_allreduce_kernel<T><<<blocks_for(numel), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), numel, static_cast<char* const*>(bases), rank, n, slot_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Allocates this rank's zeroed workspace for `n` ranks and a slot of
// `slot_bytes` on `device` and exports it: *base is the device pointer,
// handle (64 bytes, a cudaIpcMemHandle_t) what a peer maps with
// peer_workspace_open. Synchronizes the device, so the zeros are in place
// before the handle leaves the process.
extern "C" int peer_workspace_create(long long slot_bytes, int n, int device, void** base,
                                     void* handle) {
  *base = nullptr;
  cudaError_t err = cudaSetDevice(device);
  const size_t bytes = workspace_bytes(static_cast<size_t>(slot_bytes), n);
  if (err == cudaSuccess) err = cudaMalloc(base, bytes);
  if (err == cudaSuccess) err = cudaMemset(*base, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *base);
  if (err != cudaSuccess && *base) {
    cudaFree(*base);
    *base = nullptr;
  }
  return static_cast<int>(err);
}

// Maps a peer's workspace (its 64-byte handle) into this process on `device`.
extern "C" int peer_workspace_open(const void* handle, int device, void** ptr) {
  *ptr = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  const unsigned char* src = static_cast<const unsigned char*>(handle);
  unsigned char* dst = reinterpret_cast<unsigned char*>(&h);
  for (size_t i = 0; i < sizeof(h); ++i) dst[i] = src[i];
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Unmaps a peer's workspace (opened) or frees this rank's own.
extern "C" int peer_workspace_close(void* ptr, int own, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(own ? cudaFree(ptr) : cudaIpcCloseMemHandle(ptr));
}

// The sum over the n ranks of x[0..numel) in place, on `stream`: bases is a
// device array of the n workspaces' addresses in this process (this rank's
// own at `rank`), every rank calling with the same numel, n and slot_bytes.
extern "C" int peer_allreduce_f32(void* x, long long numel, const void* bases, int rank, int n,
                                  long long slot_bytes, int device, int multi_device,
                                  void* stream) {
  return launch<float>(x, numel, bases, rank, n, slot_bytes, device, multi_device, stream);
}

extern "C" int peer_allreduce_f64(void* x, long long numel, const void* bases, int rank, int n,
                                  long long slot_bytes, int device, int multi_device,
                                  void* stream) {
  return launch<double>(x, numel, bases, rank, n, slot_bytes, device, multi_device, stream);
}
