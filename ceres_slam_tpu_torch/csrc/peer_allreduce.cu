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
//   slot   [2][slot_bytes]      this rank's copies of the buffers being
//                               reduced, one a round parity
//   ready  [kMaxBlocks][n] u32  ready[b][q] = e: rank q's part b of round e
//                               is in q's slot e % 2 (written by q)
//   epoch  [kMaxBlocks]    u32  the rounds block b has run (this rank's own)
//
// The grid is fixed per workspace (its `blocks`, chosen when it is made,
// the same on every rank), and every block runs every call, whatever the
// buffer's size: so block b's epochs are the same in every block and on
// every rank, and a call's parity is the same in every block. The buffer is
// read as 16-byte vectors (double2, float4; the last one zero-padded in the
// slot); thread t of the grid takes vectors t, t + S, t + 2S, ... (S the
// grid's threads), so part b is the vectors of block b's threads.
//
// A call, round e = epoch[b] + 1 in block b: its threads copy their vectors
// of the buffer into the rank's slot e % 2; after __syncthreads(), thread q
// (q < n, q != rank) publishes e in ready[b][rank] of rank q (a release at
// system scope: fence.acq_rel.sys, then a relaxed store) and waits until
// ready[b][q] in its own workspace reaches e (acquire loads at system
// scope); after a second __syncthreads(), every thread loads its vectors
// from every peer's slot e % 2, all of them before its first add, and sums
// them with its own in rank order 0..n-1, left to right, into the buffer.
// So every rank computes the same sums in the same order: the same bits on
// every rank, those of the plain version, and no atomics (ROADMAP F14).
//
// Why a peer's loads see the slot's data: the block's stores to the slot
// come before the barrier, the barrier before thread q's fence.acq_rel.sys,
// the fence before its flag store, which the peer's acquire load reads; the
// fence is cumulative, so the peer's loads after that acquire and its own
// barrier see the stores. They are relaxed loads at system scope, which
// cannot return a stale line of the SM's L1 (the slot is rewritten every
// other round).
//
// Why one flag round is enough: rank R writes slot p = e % 2 again in round
// e + 2. Before it ends round e + 1, R has seen every peer's ready for round
// e + 1 in every block, and a peer publishes round e + 1 only from its
// kernel of round e + 1, after its kernel of round e, with all its reads of
// R's slot p, has ended (the calls on a stream run one after another). A
// peer that R sees at round e + 1 may still read R's other slot, 1 - p, in
// that round, which R does not touch until round e + 3. So no slot is
// written while a peer reads it, and the kernel returns as soon as its own
// sums are written. The epochs live in device memory and the kernel
// advances them, so a graph replayed or a WHILE node restarted keeps
// counting; every rank makes the same calls in the same order.
//
// One rank: the sum over one rank is the buffer, so the kernel returns at
// once (no copy, no fence, no flag); the launch stays, one a collective, so
// a sharded loop's node holds it as it does on several ranks.
//
// Deadlock freedom: block b waits only for block b of its peers. The grid
// is at most kMaxBlocks (32) blocks of kThreads, far below what one H100
// holds at once, so every block of a rank runs together; processes sharing
// one card take turns in time slices, and a waiting block gives way at the
// slice's end.
//
// What bounds it on an H100: the bytes each rank reads from its peers,
// (n - 1) x the buffer over NVLink's 450 GB/s each way, and for small
// buffers the latency of the flag round trip and of one 16-byte load over
// NVLink; on one rank, the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 32;
constexpr int kMaxRanks = 8;

__device__ __forceinline__ void fence_release_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 16 bytes of T, loaded from a peer's slot (relaxed, system scope: no L1)
template <typename T>
struct Vec;

template <>
struct alignas(16) Vec<double> {
  static constexpr int kWidth = 2;
  double v[2];
  static __device__ __forceinline__ Vec load_peer(const char* p) {
    Vec r;
    asm volatile("ld.relaxed.sys.global.v2.f64 {%0, %1}, [%2];"
                 : "=d"(r.v[0]), "=d"(r.v[1])
                 : "l"(p)
                 : "memory");
    return r;
  }
};

template <>
struct alignas(16) Vec<float> {
  static constexpr int kWidth = 4;
  float v[4];
  static __device__ __forceinline__ Vec load_peer(const char* p) {
    Vec r;
    asm volatile("ld.relaxed.sys.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
                 : "l"(p)
                 : "memory");
    return r;
  }
};

// Vector i of the buffer x: its elements, zero past numel.
template <typename T>
__device__ __forceinline__ Vec<T> load_own(const T* x, long long i, long long numel) {
  constexpr int w = Vec<T>::kWidth;
  Vec<T> r;
#pragma unroll
  for (int k = 0; k < w; ++k) r.v[k] = i * w + k < numel ? x[i * w + k] : T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ void store_own(T* x, long long i, long long numel, const Vec<T>& a) {
  constexpr int w = Vec<T>::kWidth;
#pragma unroll
  for (int k = 0; k < w; ++k)
    if (i * w + k < numel) x[i * w + k] = a.v[k];
}

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// Byte offsets of the workspace's parts after the two slots.
__host__ __device__ inline size_t ready_offset(size_t slot_bytes) {
  return align256(2 * slot_bytes);
}
__host__ __device__ inline size_t epoch_offset(size_t slot_bytes, int n) {
  return ready_offset(slot_bytes) + align256(sizeof(unsigned) * kMaxBlocks * n);
}
inline size_t workspace_bytes(size_t slot_bytes, int n) {
  return epoch_offset(slot_bytes, n) + align256(sizeof(unsigned) * kMaxBlocks);
}

// R: the ranks the registers hold (n <= R), so that a thread's loads of
// every peer's vectors are in flight together.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    peer_allreduce_kernel(T* __restrict__ x, long long numel, char* const* __restrict__ bases,
                          int rank, int n, long long slot_bytes) {
  if (n == 1) return;  // the sum over one rank is the buffer
  const int b = blockIdx.x;
  char* const mine = bases[rank];
  unsigned* const my_ready = reinterpret_cast<unsigned*>(mine + ready_offset(slot_bytes)) + b * n;
  unsigned* const my_epoch = reinterpret_cast<unsigned*>(mine + epoch_offset(slot_bytes, n)) + b;
  const unsigned e = *my_epoch + 1;  // only this block touches its epoch
  const long long parity = (e & 1u) * slot_bytes;
  const long long nvec = (numel + Vec<T>::kWidth - 1) / Vec<T>::kWidth;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(b) * kThreads + threadIdx.x;

  Vec<T>* const slot = reinterpret_cast<Vec<T>*>(mine + parity);
  for (long long i = first; i < nvec; i += stride) slot[i] = load_own(x, i, numel);
  __syncthreads();
  if (threadIdx.x == 0) *my_epoch = e;
  const int q = threadIdx.x;
  if (q < n && q != rank) {
    fence_release_sys();
    store_relaxed(reinterpret_cast<unsigned*>(bases[q] + ready_offset(slot_bytes)) + b * n + rank,
                  e);
    while (static_cast<int>(load_acquire(my_ready + q) - e) < 0) {
    }
  }
  __syncthreads();

  const char* peer[R];
#pragma unroll
  for (int p = 0; p < R; ++p) peer[p] = p < n ? bases[p] + parity : nullptr;
  for (long long i = first; i < nvec; i += 2 * stride) {
    const long long j = i + stride;  // a thread's second vector, if the buffer has it
    Vec<T> got[R][2];
#pragma unroll
    for (int p = 0; p < R; ++p) {
      if (p < n && p != rank) {
        got[p][0] = Vec<T>::load_peer(peer[p] + i * sizeof(Vec<T>));
        if (j < nvec) got[p][1] = Vec<T>::load_peer(peer[p] + j * sizeof(Vec<T>));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long k = h ? j : i;
      if (k >= nvec) break;
      const Vec<T> own = load_own(x, k, numel);
      Vec<T> sum;
#pragma unroll
      for (int c = 0; c < Vec<T>::kWidth; ++c) {
        T acc = rank == 0 ? own.v[c] : got[0][h].v[c];
#pragma unroll
        for (int p = 1; p < R; ++p)
          if (p < n) acc = acc + (p == rank ? own.v[c] : got[p][h].v[c]);
        sum.v[c] = acc;
      }
      store_own(x, k, numel, sum);
    }
  }
}

template <typename T>
int launch(void* x, long long numel, const void* bases, int rank, int n, long long slot_bytes,
           int blocks, int device, int multi_device, void* stream) {
  if (multi_device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n < 1 || n > kMaxRanks || blocks < 1 || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (numel <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* const px = static_cast<T*>(x);
  char* const* const pb = static_cast<char* const*>(bases);
  if (n <= 2)
    peer_allreduce_kernel<T, 2><<<blocks, kThreads, 0, s>>>(px, numel, pb, rank, n, slot_bytes);
  else if (n <= 4)
    peer_allreduce_kernel<T, 4><<<blocks, kThreads, 0, s>>>(px, numel, pb, rank, n, slot_bytes);
  else
    peer_allreduce_kernel<T, 8><<<blocks, kThreads, 0, s>>>(px, numel, pb, rank, n, slot_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Allocates this rank's zeroed workspace for `n` ranks and two slots of
// `slot_bytes` each on `device` and exports it: *base is the device pointer,
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
// own at `rank`), every rank calling with the same numel, n, slot_bytes and
// blocks (the workspace's grid, at most 32; n at most 8). slot_bytes must
// hold numel elements rounded up to 16 bytes.
extern "C" int peer_allreduce_f32(void* x, long long numel, const void* bases, int rank, int n,
                                  long long slot_bytes, int blocks, int device, int multi_device,
                                  void* stream) {
  return launch<float>(x, numel, bases, rank, n, slot_bytes, blocks, device, multi_device,
                       stream);
}

extern "C" int peer_allreduce_f64(void* x, long long numel, const void* bases, int rank, int n,
                                  long long slot_bytes, int blocks, int device, int multi_device,
                                  void* stream) {
  return launch<double>(x, numel, bases, rank, n, slot_bytes, blocks, device, multi_device,
                        stream);
}
