// Binary Gumbel relaxation with its own random numbers, and its backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_audio_autoencoder_tpu/ops/pallas_kernels.py:216
// (_binary_gumbel_kernel, launched by _binary_gumbel_pallas_call at :229),
// and the closed-form VJP that XLA fuses into one pass there (_bg_bwd, :286).
//
// Forward: one elementwise pass over the logits l (any shape, n elements),
// fp32 inside, output s in the logits' dtype:
//   u = uniform in [1e-6, 1 - 1e-6]
//   s = sigmoid((2 l - 1 + log u - log1p(-u)) / T)
// (log u - log1p(-u) is a standard logistic sample: the difference of the
// two Gumbels of the binary Gumbel-softmax).
//
// The uniforms come from csrc/philox.cuh: Philox4x32-10 keyed by the
// 64-bit seed, counter (group index, 64-bit offset), four elements per
// group, the draw starting at element `first` of the stream (so a
// data-parallel rank draws its rows of the global batch's draw; first = 0
// is the whole draw, the same bits as before `first` existed).
// ops/fused_samplers.py computes the same stream in plain torch, and the
// two agree bit for bit.
//
// Two forward entry points share the device function `relax`: one draws u
// from (seed, offset) and can also write it out (for checks against the
// plain version on the same u); the other reads u from an input tensor.
//
// Backward: dl = ct * 2 s (1 - s) / T, fp32 inside, in the plain version's
// order of operations (ops/fused_samplers.py::binary_gumbel_bwd_plain), each
// product rounded on its own; dl in s's dtype, the cotangent in either dtype.
//
// What bounds them on an H100 SXM: neither bytes nor operations but the
// launch. Per element the forward reads one logit and writes one output
// (8 bytes in fp32) for ~40 integer operations of Philox and one log, one
// log1p and one exp; at 3.35 TB/s the ~100k logits of a train step move in
// well under a microsecond, while an empty kernel takes ~0.9 us of device
// time and ~4.8 us from one event to the next. So the forward runs one
// element per thread: each thread computes its group's Philox block and
// keeps word i & 3, with its logit in flight during the rounds. One group
// per thread ran four relaxations in series on 97 blocks of 256 threads at
// the train shape. Two elements per thread (half a group, one vector
// access) measured within a few hundredths of a microsecond of it, faster
// in fp32 and slower in bf16 (PERF.md). The backward is one launch where
// the plain version is a chain of five (fp32) to eight (bf16); it runs two
// elements per thread, one vector access each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace sampler;

__device__ __forceinline__ float relax(float l, float u, float inv_t) {
  const float z = (2.0f * l - 1.0f + logistic(u)) * inv_t;
  return 1.0f / (1.0f + expf(-z));
}

constexpr int kThreads = 256;

// Thread i: element i, stream element e = first + i: word e & 3 of group e / 4.
template <typename T>
__global__ void __launch_bounds__(kThreads) philox_kernel(const T* __restrict__ logits,
                                                          T* __restrict__ out,
                                                          float* __restrict__ u_out, int64_t n,
                                                          uint64_t first, uint32_t seed_lo,
                                                          uint32_t seed_hi, uint32_t off_lo,
                                                          uint32_t off_hi, float inv_t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float l = to_float(logits[i]);  // in flight during the Philox rounds
  const uint64_t e = first + (uint64_t)i;
  const uint4 r = philox_block((int64_t)(e >> 2), seed_lo, seed_hi, off_lo, off_hi);
  const float u = bits_to_uniform(word(r, (int)(e & 3)));
  out[i] = from_float<T>(relax(l, u, inv_t));
  if (u_out != nullptr) u_out[i] = u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) noise_kernel(const T* __restrict__ logits,
                                                         const float* __restrict__ u,
                                                         T* __restrict__ out, int64_t n,
                                                         float inv_t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = from_float<T>(relax(to_float(logits[i]), u[i], inv_t));
}

// The backward's elements per thread (one access each where whole and
// aligned) and block.
constexpr int kBwdPer = 2;
constexpr int kBwdThreads = 128;

// dl = ct * (2 s (1 - s) / T), rounded as torch rounds each operation.
template <typename T, typename C>
__global__ void __launch_bounds__(kBwdThreads) bwd_kernel(const T* __restrict__ s,
                                                          const C* __restrict__ ct,
                                                          T* __restrict__ dl, int64_t n, float t,
                                                          bool aligned_io) {
  const int64_t base = kBwdPer * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (base >= n) return;
  const bool whole = aligned_io && base + kBwdPer <= n;
  float sf[kBwdPer], cf[kBwdPer], d[kBwdPer];
  load<kBwdPer>(s, base, n, whole, sf);
  load<kBwdPer>(ct, base, n, whole, cf);
#pragma unroll
  for (int j = 0; j < kBwdPer; ++j) {
    const float ds = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, sf[j]), __fsub_rn(1.0f, sf[j])), t);
    d[j] = __fmul_rn(cf[j], ds);
  }
  store<kBwdPer>(dl, base, n, whole, d);
}

unsigned blocks_for(int64_t n, int per, int threads) {
  return (unsigned)(((n + per - 1) / per + threads - 1) / threads);
}

template <typename T>
int launch_bwd(const void* s, const void* ct, void* dl, int64_t n, float t, int ct_dtype,
               cudaStream_t stream) {
  if (ct_dtype == 0) {
    bwd_kernel<T, float><<<blocks_for(n, kBwdPer, kBwdThreads), kBwdThreads, 0, stream>>>(
        static_cast<const T*>(s), static_cast<const float*>(ct), static_cast<T*>(dl), n, t,
        aligned<kBwdPer, T>(s) && aligned<kBwdPer, float>(ct) && aligned<kBwdPer, T>(dl));
  } else if (ct_dtype == 1) {
    bwd_kernel<T, __nv_bfloat16><<<blocks_for(n, kBwdPer, kBwdThreads), kBwdThreads, 0, stream>>>(
        static_cast<const T*>(s), static_cast<const __nv_bfloat16*>(ct), static_cast<T*>(dl), n, t,
        aligned<kBwdPer, T>(s) && aligned<kBwdPer, __nv_bfloat16>(ct) && aligned<kBwdPer, T>(dl));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. u_out may be null. The draw starts at
// element `first` of the stream. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.
extern "C" int binary_gumbel_philox(const void* logits, void* out, void* u_out, int64_t n,
                                    uint64_t seed, uint64_t offset, uint64_t first,
                                    float temperature, int dtype, void* stream) {
  if (n < 0 || !(temperature > 0.0f) || first > UINT64_MAX - (uint64_t)n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t slo = (uint32_t)seed, shi = (uint32_t)(seed >> 32);
  const uint32_t olo = (uint32_t)offset, ohi = (uint32_t)(offset >> 32);
  const float inv_t = 1.0f / temperature;
  if (dtype == 0) {
    philox_kernel<float><<<blocks_for(n, 1, kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(out), static_cast<float*>(u_out), n,
        first, slo, shi, olo, ohi, inv_t);
  } else if (dtype == 1) {
    philox_kernel<__nv_bfloat16><<<blocks_for(n, 1, kThreads), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(u_out), n, first, slo, shi, olo, ohi, inv_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Same relaxation on given uniforms u (fp32, n elements).
extern "C" int binary_gumbel_noise(const void* logits, const void* u, void* out, int64_t n,
                                   float temperature, int dtype, void* stream) {
  if (n < 0 || !(temperature > 0.0f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_t = 1.0f / temperature;
  if (dtype == 0) {
    noise_kernel<float><<<blocks_for(n, 1, kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const float*>(u), static_cast<float*>(out),
        n, inv_t);
  } else if (dtype == 1) {
    noise_kernel<__nv_bfloat16><<<blocks_for(n, 1, kThreads), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<const float*>(u),
        static_cast<__nv_bfloat16*>(out), n, inv_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The backward: dl = ct * 2 s (1 - s) / T over n elements. dtype is s's
// and dl's, ct_dtype the cotangent's (0 = float32, 1 = bfloat16).
extern "C" int binary_gumbel_bwd(const void* s, const void* ct, void* dl, int64_t n,
                                 float temperature, int dtype, int ct_dtype, void* stream) {
  if (n < 0 || !(temperature > 0.0f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(s, ct, dl, n, temperature, ct_dtype, st);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(s, ct, dl, n, temperature, ct_dtype, st);
  return (int)cudaErrorInvalidValue;
}
