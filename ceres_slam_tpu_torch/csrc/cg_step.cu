// The update of a preconditioned CG iteration of full-batch bundle
// adjustment's reduced camera system (solver/pcg.py), for Hopper, sm_90a.
//
// The iteration's matvec, csrc/schur_uy.cu's schur_sp, leaves Sp = S p and
// each pose's share of p . Sp. This kernel does everything after it: for K
// poses, the state x, r, z, p [K, 6] and rz, the block-Jacobi
// preconditioner's lower Cholesky factors L [K, 6, 6] (all NaN where a
// factorization failed), the stop bound, the count i and the test pred,
//   alpha = rz / (p . Sp, or 1 where that is 0)
//   x += alpha p,  r -= alpha Sp,  z = L^-T (L^-1 r)  (two triangular solves)
//   rz' = r . z,  beta = rz' / (rz, or 1 where that is 0),  p = z + beta p
//   rz = rz',  i += 1,  pred = (i < max_iters) & (sqrt(r . r) > bound)
// which pcg.cg_body and the in-place body of pcg._cg_in_place compute with
// ~35 PyTorch kernels. Each product, sum and difference of vector entries
// is rounded alone (no fused multiply-add), as those kernels round it; the
// triangular solves and the dots run in an order of their own, fixed, so
// the result is the same bits run to run. No atomics. A NaN factor makes z,
// rz and every later alpha NaN, so r turns NaN, the test fails and the loop
// stops with a NaN step, which the LM loop rejects, as with the plain body.
//
// What bounds it: neither bytes nor operations, but latency. At kitti1100
// (K = 1,100, float64) it reads 0.51 MB (the factors' lower triangles 185
// KB, x, r, p, Sp, z) and writes 0.21 MB, 0.22 us at 3.35 TB/s; the ~35
// kernels it replaces each cost a graph node's launch of ~2 us inside a
// WHILE node. Its own chain is two global sums, the loads of a pose and
// twelve dependent divisions.
//
// Design: two launches, each a grid of 64-thread blocks, a thread a pose.
// alpha needs the global p . Sp and beta the global r . z, and between them
// every pose's update: one launch would need a grid-wide barrier. So
// cg_update_blocks has every block sum all K shares of p . Sp in the same
// fixed tree (so every block holds the same alpha), update its poses with
// the two triangular solves in registers and leave its block's shares of
// r . z and r . r; cg_direction has every block sum those shares in the
// same tree, and rewrite its poses' p. Sums load their terms before adding
// them (in order), so a sum costs one load's latency, not one a term. One
// SM for the whole update (a block of 1024 threads, one launch) measured
// 44 us of device time against 7.7 us for the two launches, and 61 against
// 27 us a CG iteration in the WHILE node (PERF.md).

#include <cuda_runtime.h>

// cg_update's arguments (ops/cg_kernel.py::_CgArgs).
struct CgArgs {
  void* x;
  void* r;
  void* z;
  void* p;
  void* rz;  // 0-d
  const void* sp;
  const void* dots;  // [K]: p_k . Sp_k
  // [K, 6, 6], blocks column-major as a batched Cholesky leaves them:
  // L_k[i][j] at 36 k + i + 6 j
  const void* chol;
  const void* bound;  // 0-d
  int* i;
  int* pred;
  void* scratch;  // [2 blocks + 1]: the blocks' shares of r . z, of r . r, and rz
  int K;
  int max_iters;
  int device;
  int multi_device;  // more than one device visible: launch on `device`
};

namespace {

constexpr int kBlock = 64;  // threads a block, a pose a thread
constexpr int kUnroll = 32;  // terms of a strided sum loaded before they are added
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The block's sums of v[0 .. M) in a fixed tree (a shuffle tree a warp, then
// the warps in order); every thread gets the same bits.
template <int NT, int M, typename T>
__device__ __forceinline__ void block_sums(T (&v)[M], T (*red)[NT / 32]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[m] += __shfl_xor_sync(kFull, v[m], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) red[m][threadIdx.x >> 5] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T s = red[m][0];
    for (int w = 1; w < NT / 32; ++w) s += red[m][w];
    v[m] = s;
  }
  __syncthreads();
}

// sum_{k = t, t + kBlock, ...} a[k] for k < n, in that order.
template <typename T>
__device__ __forceinline__ T strided_sum(const T* a, int n, int t) {
  T d = T(0);
  for (int k0 = t; k0 < n; k0 += kUnroll * kBlock) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kBlock;
      v[u] = k < n ? a[k] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * kBlock < n) d = add_rn(d, v[u]);
    }
  }
  return d;
}

// A pose's inputs, loaded before the sum that gives alpha so their latency
// overlaps it: x, r, p, Sp and the lower triangle of L, row by row.
template <typename T>
struct Pose {
  T x[6], r[6], p[6], sp[6], L[21];
};

template <typename T>
__device__ __forceinline__ void load_pose(const CgArgs& a, int k, Pose<T>& q) {
  const size_t o = 6 * static_cast<size_t>(k);
  const T* L = static_cast<const T*>(a.chol) + 36 * static_cast<size_t>(k);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    q.x[m] = static_cast<const T*>(a.x)[o + m];
    q.r[m] = static_cast<const T*>(a.r)[o + m];
    q.p[m] = static_cast<const T*>(a.p)[o + m];
    q.sp[m] = static_cast<const T*>(a.sp)[o + m];
#pragma unroll
    for (int j = 0; j <= m; ++j) q.L[m * (m + 1) / 2 + j] = L[m + 6 * j];
  }
}

// Pose k: x and r updated, z = L^-T L^-1 r written; adds its shares of
// r . z and r . r to zr.
template <typename T>
__device__ __forceinline__ void update_pose(const CgArgs& a, int k, T alpha, const Pose<T>& q,
                                            T (&zr)[2]) {
  const size_t o = 6 * static_cast<size_t>(k);
  T r[6], z[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    static_cast<T*>(a.x)[o + m] = add_rn(q.x[m], mul_rn(alpha, q.p[m]));
    r[m] = sub_rn(q.r[m], mul_rn(alpha, q.sp[m]));
    static_cast<T*>(a.r)[o + m] = r[m];
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {  // L y = r
    T t = r[m];
#pragma unroll
    for (int j = 0; j < m; ++j) t -= q.L[m * (m + 1) / 2 + j] * z[j];
    z[m] = t / q.L[m * (m + 1) / 2 + m];
  }
#pragma unroll
  for (int m = 5; m >= 0; --m) {  // L^T z = y
    T t = z[m];
#pragma unroll
    for (int j = m + 1; j < 6; ++j) t -= q.L[j * (j + 1) / 2 + m] * z[j];
    z[m] = t / q.L[m * (m + 1) / 2 + m];
  }
  T rz = T(0), rr = T(0);
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    static_cast<T*>(a.z)[o + m] = z[m];
    rz = add_rn(rz, mul_rn(r[m], z[m]));
    rr = add_rn(rr, mul_rn(r[m], r[m]));
  }
  zr[0] = add_rn(zr[0], rz);
  zr[1] = add_rn(zr[1], rr);
}

template <typename T>
__device__ __forceinline__ void finish(const CgArgs& a, T rz_new, T rr) {
  *static_cast<T*>(a.rz) = rz_new;
  const int i = *a.i + 1;
  *a.i = i;
  *a.pred = (i < a.max_iters) & (sqrt(rr) > *static_cast<const T*>(a.bound));
}

// Every block sums the K shares of p . Sp in the same tree (the same
// alpha), updates its poses and leaves its shares of r . z and r . r;
// block 0 keeps rz for cg_direction, which writes it.
template <typename T>
__global__ void __launch_bounds__(kBlock) cg_update_blocks(const CgArgs a) {
  __shared__ T red[2][kBlock / 32];
  const int tid = threadIdx.x, K = a.K, nb = gridDim.x;
  const int k = blockIdx.x * kBlock + tid;
  Pose<T> q;
  if (k < K) load_pose(a, k, q);
  const T rz = *static_cast<const T*>(a.rz);
  T d[1] = {strided_sum(static_cast<const T*>(a.dots), K, tid)};
  block_sums<kBlock>(d, red);
  const T alpha = rz / (d[0] == T(0) ? T(1) : d[0]);
  T zr[2] = {T(0), T(0)};
  if (k < K) update_pose(a, k, alpha, q, zr);
  block_sums<kBlock>(zr, red);
  if (tid == 0) {
    T* s = static_cast<T*>(a.scratch);
    s[blockIdx.x] = zr[0];
    s[nb + blockIdx.x] = zr[1];
    if (blockIdx.x == 0) s[2 * nb] = rz;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) cg_direction(const CgArgs a) {
  __shared__ T red[2][kBlock / 32];
  const int tid = threadIdx.x, nb = gridDim.x, k = blockIdx.x * kBlock + tid;
  const size_t o = 6 * static_cast<size_t>(k);
  T z[6], p[6];  // p_k = z_k + beta p_k, loaded before beta is known
  if (k < a.K) {
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      z[m] = static_cast<const T*>(a.z)[o + m];
      p[m] = static_cast<const T*>(a.p)[o + m];
    }
  }
  const T* s = static_cast<const T*>(a.scratch);
  T zr[2] = {strided_sum(s, nb, tid), strided_sum(s + nb, nb, tid)};
  block_sums<kBlock>(zr, red);
  const T rz = s[2 * nb];
  const T beta = zr[0] / (rz == T(0) ? T(1) : rz);
  if (k < a.K) {
#pragma unroll
    for (int m = 0; m < 6; ++m) static_cast<T*>(a.p)[o + m] = add_rn(z[m], mul_rn(beta, p[m]));
  }
  if (blockIdx.x == 0 && tid == 0) finish(a, zr[0], zr[1]);
}

template <typename T>
int launch(const CgArgs* a, void* stream) {
  if (a->K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int current = a->device;
  if (a->multi_device) cudaGetDevice(&current);
  if (current != a->device) cudaSetDevice(a->device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (a->K + kBlock - 1) / kBlock;
  cg_update_blocks<T><<<nb, kBlock, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    cg_direction<T><<<nb, kBlock, 0, s>>>(*a);
    err = cudaGetLastError();
  }
  if (current != a->device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int cg_update_f32(const CgArgs* a, void* stream) { return launch<float>(a, stream); }

int cg_update_f64(const CgArgs* a, void* stream) { return launch<double>(a, stream); }

}  // extern "C"
