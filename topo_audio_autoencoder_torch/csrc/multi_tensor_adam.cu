// The optimizer's update over every leaf of a model at once, for Hopper
// (sm_90a): optax's clip_by_global_norm, then scale_by_adam and each leaf's
// learning rate, in two launches.
//
// Replaces no TPU kernel. In the JAX package XLA fuses optax's update over
// the whole tree; the port's optimizer took about 20 torch operations a
// leaf, over 6,000 launches an update for the flagship's 315 leaves, each
// a few microseconds of device work and more of the host's
// (training/train_step.py::Optimizer). ops/multi_tensor_adam.py holds the
// plain version (clip_adam_plain) and the wrapper.
//
// The leaves come by value, in the kernels' parameters (Table, up to
// kMaxLeaves leaves: CUDA 12.1 takes 32,764 bytes of parameters): each
// leaf's fp32 gradient, parameter and two moments (one pointer each; the
// moments of a flat group are pointers into its vector), its size and the
// negated learning rate of its group. Each leaf is cut into kChunk-element
// chunks, numbered leaf after leaf (first_chunk: a leaf's first chunk, the
// count of all of them last; an empty leaf owns none). Within a chunk
// thread t takes the four-element slots t, t + kThreads, ..., one 16-byte
// access each where the four pointers are aligned, four scalar ones
// otherwise: the same elements to the same thread either way.
//
// 1. norm_kernel: kNormBlocks blocks; block b sums the squares of chunks
//    b, b + kNormBlocks, ... (each thread in its own order, then a fixed
//    tree) into partials[b]. No atomics: the order is fixed by the sizes,
//    so two calls, and data-parallel ranks, give the same bits.
// 2. clip_adam_kernel: every block first sums the partials in one fixed
//    order (every block the same bits) to the norm, then, over its chunks,
//    per element, exactly the plain version's arithmetic, each operation
//    rounded on its own (no contraction into FMAs):
//      g  = norm < max_norm ? g : (g / norm) * max_norm
//      mu = (1 - b1) g + b1 mu,   nu = (1 - b2) (g g) + b2 nu
//      p += ((mu * inv_bc1) / (sqrt(nu * inv_bc2) + eps)) * (-lr)
//    torch divides a tensor by a Python float as the product with the
//    float's fp32 reciprocal; the wrapper passes inv_bc1 and inv_bc2 so.
//    Where the clip does not engage this gives the plain version's bits;
//    where it does, the norm differs from the plain version's sum of
//    per-leaf sums in its order of summation only.
//
// What bounds them on an H100 SXM: bytes. The norm reads each gradient once
// (4 bytes an element), the update reads the gradient, the parameter and
// both moments and writes the last three (28 bytes): 72 MB of gradient take
// ~0.17 ms at 3.35 TB/s. So the update is one streaming pass, 16-byte
// accesses, 16 elements a thread in flight from each of four arrays, a grid
// sized to fill every SM once (grid-stride over the chunks), and no shared
// memory beyond the reductions'.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "multi_tensor_adam.cu passes its leaf table as a kernel parameter of ~31 KB, which needs CUDA 12.1 or later"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;                        // four-element slots a thread takes in a chunk
constexpr int kChunk = kThreads * kSlots * 4;    // 4,096 elements
constexpr int kNormBlocks = 512;
constexpr int kMaxLeaves = 700;

struct Table {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* mu[kMaxLeaves];
  float* nu[kMaxLeaves];
  float neg_lr[kMaxLeaves];
  int32_t n[kMaxLeaves];
  int32_t first_chunk[kMaxLeaves + 1];
  int32_t count;
};
static_assert(sizeof(Table) + 64 <= 32764, "the leaf table must fit the kernel parameters");

struct Adam {
  float max_norm, c1, b1, c2, b2, inv_bc1, inv_bc2, eps;
};

// The leaf that owns chunk c (the last leaf whose first chunk is <= c:
// empty leaves before it share its first chunk and own none).
__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int lo = 0, hi = t.count;  // first_chunk[lo] <= c < first_chunk[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.first_chunk[mid] <= c) lo = mid;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Thread t's elements of a chunk of `len` elements at `base`, zero past its end.
__device__ __forceinline__ void load(const float* __restrict__ base, int len, bool vec, float (&x)[4 * kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = 4 * (threadIdx.x + k * kThreads);
    if (vec && e + 4 <= len) {
      const float4 v = *reinterpret_cast<const float4*>(base + e);
      x[4 * k] = v.x;
      x[4 * k + 1] = v.y;
      x[4 * k + 2] = v.z;
      x[4 * k + 3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[4 * k + i] = e + i < len ? base[e + i] : 0.0f;
    }
  }
}

__device__ __forceinline__ void store(float* __restrict__ base, int len, bool vec, const float (&x)[4 * kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = 4 * (threadIdx.x + k * kThreads);
    if (vec && e + 4 <= len) {
      *reinterpret_cast<float4*>(base + e) = make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e + i < len) base[e + i] = x[4 * k + i];
    }
  }
}

// The block's sum, the same bits in every thread: a butterfly in each warp
// (commutative at every node), then the warps' sums in warp order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
  return s;
}

// Where chunk c lies: its leaf, its first element in the leaf and its length.
__device__ __forceinline__ int chunk_of(const Table& t, int c, int64_t& start, int& len) {
  const int leaf = leaf_of(t, c);
  start = (int64_t)(c - t.first_chunk[leaf]) * kChunk;
  len = (int)min((int64_t)kChunk, (int64_t)t.n[leaf] - start);
  return leaf;
}

__global__ void __launch_bounds__(kThreads) norm_kernel(const __grid_constant__ Table t, float* __restrict__ partials) {
  float acc = 0.0f;
  const int total = t.first_chunk[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    int64_t start;
    int len;
    const int leaf = chunk_of(t, c, start, len);
    const float* g = t.g[leaf] + start;
    float x[4 * kSlots];
    load(g, len, aligned16(g), x);
#pragma unroll
    for (int i = 0; i < 4 * kSlots; ++i) acc = __fmaf_rn(x[i], x[i], acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads) clip_adam_kernel(const __grid_constant__ Table t,
                                                             const float* __restrict__ partials,
                                                             int n_partials, Adam a) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) acc = __fadd_rn(acc, partials[i]);
  const float norm = __fsqrt_rn(block_sum(acc));
  const bool keep = norm < a.max_norm;
  const int total = t.first_chunk[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    int64_t start;
    int len;
    const int leaf = chunk_of(t, c, start, len);
    const float* g = t.g[leaf] + start;
    float* p = t.p[leaf] + start;
    float* mu = t.mu[leaf] + start;
    float* nu = t.nu[leaf] + start;
    const bool vec = aligned16(g) && aligned16(p) && aligned16(mu) && aligned16(nu);
    const float neg_lr = t.neg_lr[leaf];
    float gx[4 * kSlots], px[4 * kSlots], mx[4 * kSlots], vx[4 * kSlots];
    load(g, len, vec, gx);
    load(p, len, vec, px);
    load(mu, len, vec, mx);
    load(nu, len, vec, vx);
#pragma unroll
    for (int i = 0; i < 4 * kSlots; ++i) {
      const float gi = keep ? gx[i] : __fmul_rn(__fdiv_rn(gx[i], norm), a.max_norm);
      mx[i] = __fadd_rn(__fmul_rn(a.c1, gi), __fmul_rn(a.b1, mx[i]));
      vx[i] = __fadd_rn(__fmul_rn(a.c2, __fmul_rn(gi, gi)), __fmul_rn(a.b2, vx[i]));
      const float u = __fdiv_rn(__fmul_rn(mx[i], a.inv_bc1),
                                __fadd_rn(__fsqrt_rn(__fmul_rn(vx[i], a.inv_bc2)), a.eps));
      px[i] = __fadd_rn(px[i], __fmul_rn(u, neg_lr));
    }
    store(p, len, vec, px);
    store(mu, len, vec, mx);
    store(nu, len, vec, vx);
  }
}

// One launch's table from the wrapper's host arrays: ptrs [4][count] (the
// gradients', parameters', first and second moments' addresses), sizes,
// first_chunk [count + 1], neg_lr.
int fill(Table& t, const uint64_t* ptrs, const int32_t* sizes, const int32_t* first_chunk, const float* neg_lr,
         int count) {
  if (count < 1 || count > kMaxLeaves || first_chunk[0] != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    if (sizes[i] < 0 || first_chunk[i + 1] != first_chunk[i] + (sizes[i] + kChunk - 1) / kChunk)
      return (int)cudaErrorInvalidValue;
    t.g[i] = reinterpret_cast<const float*>(ptrs[i]);
    t.p[i] = reinterpret_cast<float*>(ptrs[count + i]);
    t.mu[i] = reinterpret_cast<float*>(ptrs[2 * count + i]);
    t.nu[i] = reinterpret_cast<float*>(ptrs[3 * count + i]);
    t.n[i] = sizes[i];
    t.neg_lr[i] = neg_lr == nullptr ? 0.0f : neg_lr[i];
    t.first_chunk[i] = first_chunk[i];
  }
  t.first_chunk[count] = first_chunk[count];
  t.count = count;
  return (int)cudaSuccess;
}

// The update's grid: every SM filled once (the bits do not depend on it).
int apply_blocks(int total) {
  static int cap = 0;
  if (cap == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clip_adam_kernel, kThreads, 0);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  return total < cap ? total : cap;
}

}  // namespace

// The constants the wrapper plans with; it refuses a library whose
// constants differ from its own.
extern "C" void multi_tensor_adam_limits(int* chunk, int* max_leaves, int* norm_blocks) {
  *chunk = kChunk;
  *max_leaves = kMaxLeaves;
  *norm_blocks = kNormBlocks;
}

// Pass 1 over one table of `count` leaves: writes kNormBlocks partial sums
// of squares at `partials`. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 = cudaSuccess) or cudaErrorInvalidValue for
// a table it does not take.
extern "C" int multi_tensor_norm(const uint64_t* ptrs, const int32_t* sizes, const int32_t* first_chunk, int count,
                                 float* partials, void* stream) {
  Table t;
  const int err = fill(t, ptrs, sizes, first_chunk, nullptr, count);
  if (err != (int)cudaSuccess) return err;
  norm_kernel<<<kNormBlocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, partials);
  return (int)cudaGetLastError();
}

// Pass 2 over one table: reads all n_partials partial sums (every table's
// pass 1), then clips and applies Adam in place. scalars: max_norm, 1 - b1,
// b1, 1 - b2, b2, the fp32 reciprocals of the two bias corrections, eps.
extern "C" int multi_tensor_clip_adam(const uint64_t* ptrs, const int32_t* sizes, const int32_t* first_chunk,
                                      const float* neg_lr, int count, const float* partials, int n_partials,
                                      const float* scalars, void* stream) {
  Table t;
  const int err = fill(t, ptrs, sizes, first_chunk, neg_lr, count);
  if (err != (int)cudaSuccess) return err;
  if (n_partials < 1) return (int)cudaErrorInvalidValue;
  const Adam a{scalars[0], scalars[1], scalars[2], scalars[3], scalars[4], scalars[5], scalars[6], scalars[7]};
  const int total = t.first_chunk[count];
  if (total == 0) return (int)cudaSuccess;
  clip_adam_kernel<<<apply_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, partials,
                                                                                           n_partials, a);
  return (int)cudaGetLastError();
}
