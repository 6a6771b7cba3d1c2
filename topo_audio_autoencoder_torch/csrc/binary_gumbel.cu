// Binary Gumbel relaxation with its own random numbers, for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_audio_autoencoder_tpu/ops/pallas_kernels.py:216
// (_binary_gumbel_kernel, launched by _binary_gumbel_pallas_call at :229).
// One elementwise pass over the logits l (any shape, n elements), fp32
// inside, output s in the logits' dtype:
//   u = uniform in [1e-6, 1 - 1e-6]
//   s = sigmoid((2 l - 1 + log u - log1p(-u)) / T)
// (log u - log1p(-u) is a standard logistic sample: the difference of the
// two Gumbels of the binary Gumbel-softmax).
//
// The uniforms come from csrc/philox.cuh: Philox4x32-10 keyed by the
// 64-bit seed, counter (group index, 64-bit offset), four elements per
// group. ops/fused_samplers.py computes the same stream in plain torch, and
// the two agree bit for bit.
//
// Two entry points share the device function `relax`: one draws u from
// (seed, offset) and can also write it out (for checks against the plain
// version on the same u); the other reads u from an input tensor.
//
// What bounds it on an H100 SXM: bytes. Per element it reads one logit and
// writes one output (8 bytes in fp32) for ~40 integer operations of Philox
// and one log, one log1p and one exp; at 3.35 TB/s the ~100k logits of a
// train step move in well under a microsecond, so one launch costs its
// launch latency. One thread per four elements, 256 threads per block.

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

template <typename T>
__global__ void __launch_bounds__(256) philox_kernel(const T* __restrict__ logits,
                                                     T* __restrict__ out, float* __restrict__ u_out,
                                                     int64_t n, uint32_t seed_lo, uint32_t seed_hi,
                                                     uint32_t off_lo, uint32_t off_hi,
                                                     float inv_t) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = g * 4;
  if (base >= n) return;
  const uint4 r = philox_block(g, seed_lo, seed_hi, off_lo, off_hi);
  const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t i = base + j;
    if (i < n) {
      const float u = bits_to_uniform(words[j]);
      out[i] = from_float<T>(relax(to_float(logits[i]), u, inv_t));
      if (u_out != nullptr) u_out[i] = u;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) noise_kernel(const T* __restrict__ logits,
                                                    const float* __restrict__ u,
                                                    T* __restrict__ out, int64_t n, float inv_t) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = from_float<T>(relax(to_float(logits[i]), u[i], inv_t));
}

constexpr int kThreads = 256;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. u_out may be null. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take. Launches on
// `stream` and does not synchronise.
extern "C" int binary_gumbel_philox(const void* logits, void* out, void* u_out, int64_t n,
                                    uint64_t seed, uint64_t offset, float temperature,
                                    int dtype, void* stream) {
  if (n < 0 || !(temperature > 0.0f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t groups = (n + 3) / 4;
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t slo = (uint32_t)seed, shi = (uint32_t)(seed >> 32);
  const uint32_t olo = (uint32_t)offset, ohi = (uint32_t)(offset >> 32);
  const float inv_t = 1.0f / temperature;
  if (dtype == 0) {
    philox_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<float*>(out), static_cast<float*>(u_out), n,
        slo, shi, olo, ohi, inv_t);
  } else if (dtype == 1) {
    philox_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(u_out), n, slo, shi, olo, ohi, inv_t);
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
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_t = 1.0f / temperature;
  if (dtype == 0) {
    noise_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const float*>(u), static_cast<float*>(out),
        n, inv_t);
  } else if (dtype == 1) {
    noise_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), static_cast<const float*>(u),
        static_cast<__nv_bfloat16*>(out), n, inv_t);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
