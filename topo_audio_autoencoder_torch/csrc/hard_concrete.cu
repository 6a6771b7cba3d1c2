// Hard Concrete gates with their own random numbers, for Hopper (sm_90a).
//
// Replaces two TPU kernels of topo_audio_autoencoder_tpu/ops/pallas_kernels.py:
//   - :61  _hard_concrete_kernel (launched by _hard_concrete_pallas_call at
//     :81): a fixed stretch, T, gamma and zeta scalars;
//   - :127 _hard_concrete_learned_kernel (launched by
//     _hard_concrete_learned_pallas_call at :149): per-simplex rows beta
//     (in place of T), gamma and zeta, element i of a [B, S] log-alpha
//     reading column i % S.
// One elementwise pass over log-alpha a (n elements), fp32 inside, output z
// in a's dtype, in the plain version's order of operations
// (ops/fused_hard_concrete.py::hard_concrete_plain):
//   u = uniform in [1e-6, 1 - 1e-6]
//   s = sigmoid((log u - log1p(-u) + a) / T)
//   z = clip(s * (zeta - gamma) + gamma, 0, 1)
// The products and sums are rounded one by one (no fused multiply-add), as
// torch rounds them, so a clipped gate lands on the same side of 0 and 1
// as the plain version's unless its pre-clip value is within an ulp.
//
// The uniforms come from csrc/philox.cuh: Philox4x32-10 keyed by the 64-bit
// seed, counter (group index, 64-bit offset), four elements per group, the
// stream binary_gumbel.cu draws and ops/fused_samplers.py::philox_uniform
// reproduces bit for bit. Each variant has a second entry point that reads
// the uniforms from a tensor (how the tests hand both packages the same
// numbers). The TPU kernels pad log-alpha to (8, 128) tiles and the
// stretch rows with 1/0/1; here nothing is padded: a thread masks the
// ragged end itself.
//
// What bounds it on an H100 SXM: bytes. Per element it reads one log-alpha
// and writes one gate (8 bytes in fp32), plus the three fp32 rows once for
// the learned variant, for about 45 operations (a quarter of a Philox
// block, log, log1p, exp, a divide, the stretch and the clip). At 3.35 TB/s
// the [32, 6195] gates of a train step move in under half a microsecond,
// so a launch costs its launch latency. One thread per four elements, 256
// threads per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace sampler;

__device__ __forceinline__ float gate(float a, float u, float t, float gamma, float zeta) {
  const float x = __fdiv_rn(__fadd_rn(logistic(u), a), t);
  const float s = 1.0f / (1.0f + expf(-x));
  const float z = __fadd_rn(__fmul_rn(s, __fsub_rn(zeta, gamma)), gamma);
  return fminf(fmaxf(z, 0.0f), 1.0f);
}

// The stretch of element i: scalars (rows == nullptr) or column i % cols.
struct Stretch {
  const float* beta;
  const float* gamma;
  const float* zeta;
  int64_t cols;
  float t, g, z;

  __device__ __forceinline__ float3 at(int64_t i) const {
    if (beta == nullptr) return make_float3(t, g, z);
    const int64_t c = i % cols;
    return make_float3(beta[c], gamma[c], zeta[c]);
  }
};

template <typename T>
__global__ void __launch_bounds__(256) philox_kernel(const T* __restrict__ log_alpha,
                                                     T* __restrict__ out, float* __restrict__ u_out,
                                                     int64_t n, Stretch st, uint32_t seed_lo,
                                                     uint32_t seed_hi, uint32_t off_lo,
                                                     uint32_t off_hi) {
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
      const float3 p = st.at(i);
      out[i] = from_float<T>(gate(to_float(log_alpha[i]), u, p.x, p.y, p.z));
      if (u_out != nullptr) u_out[i] = u;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) noise_kernel(const T* __restrict__ log_alpha,
                                                    const float* __restrict__ u,
                                                    T* __restrict__ out, int64_t n, Stretch st) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float3 p = st.at(i);
  out[i] = from_float<T>(gate(to_float(log_alpha[i]), u[i], p.x, p.y, p.z));
}

constexpr int kThreads = 256;

int launch(const void* log_alpha, const void* u, void* out, void* u_out, int64_t n,
           const Stretch& st, uint64_t seed, uint64_t offset, int dtype, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u == nullptr) {
    const int64_t groups = (n + 3) / 4;
    const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
    const uint32_t slo = (uint32_t)seed, shi = (uint32_t)(seed >> 32);
    const uint32_t olo = (uint32_t)offset, ohi = (uint32_t)(offset >> 32);
    if (dtype == 0) {
      philox_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(log_alpha), static_cast<float*>(out),
          static_cast<float*>(u_out), n, st, slo, shi, olo, ohi);
    } else if (dtype == 1) {
      philox_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(log_alpha), static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(u_out), n, st, slo, shi, olo, ohi);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (dtype == 0) {
      noise_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(log_alpha), static_cast<const float*>(u),
          static_cast<float*>(out), n, st);
    } else if (dtype == 1) {
      noise_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(log_alpha), static_cast<const float*>(u),
          static_cast<__nv_bfloat16*>(out), n, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

Stretch fixed(float temperature, float gamma, float zeta) {
  return Stretch{nullptr, nullptr, nullptr, 1, temperature, gamma, zeta};
}

Stretch rows(const void* beta, const void* gamma, const void* zeta, int64_t cols) {
  return Stretch{static_cast<const float*>(beta), static_cast<const float*>(gamma),
                 static_cast<const float*>(zeta), cols, 0.0f, 0.0f, 0.0f};
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16 (log-alpha and out);
// uniforms and stretch rows are float32. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.

// Fixed stretch, uniforms from (seed, offset); u_out (may be null) receives them.
extern "C" int hard_concrete_philox(const void* log_alpha, void* out, void* u_out, int64_t n,
                                    uint64_t seed, uint64_t offset, float temperature,
                                    float gamma, float zeta, int dtype, void* stream) {
  if (n < 0 || !(temperature > 0.0f) || !(zeta > gamma)) return (int)cudaErrorInvalidValue;
  return launch(log_alpha, nullptr, out, u_out, n, fixed(temperature, gamma, zeta), seed, offset,
                dtype, stream);
}

// Fixed stretch on given uniforms u (n elements).
extern "C" int hard_concrete_noise(const void* log_alpha, const void* u, void* out, int64_t n,
                                   float temperature, float gamma, float zeta, int dtype,
                                   void* stream) {
  if (n < 0 || u == nullptr || !(temperature > 0.0f) || !(zeta > gamma))
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, u, out, nullptr, n, fixed(temperature, gamma, zeta), 0, 0, dtype,
                stream);
}

// Learned stretch: beta, gamma, zeta are [cols] rows; n is a multiple of cols.
extern "C" int hard_concrete_learned_philox(const void* log_alpha, const void* beta,
                                            const void* gamma, const void* zeta, void* out,
                                            void* u_out, int64_t n, int64_t cols, uint64_t seed,
                                            uint64_t offset, int dtype, void* stream) {
  if (n < 0 || cols <= 0 || n % cols != 0 || beta == nullptr || gamma == nullptr ||
      zeta == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, nullptr, out, u_out, n, rows(beta, gamma, zeta, cols), seed, offset,
                dtype, stream);
}

// Learned stretch on given uniforms u (n elements).
extern "C" int hard_concrete_learned_noise(const void* log_alpha, const void* u,
                                           const void* beta, const void* gamma, const void* zeta,
                                           void* out, int64_t n, int64_t cols, int dtype,
                                           void* stream) {
  if (n < 0 || cols <= 0 || n % cols != 0 || u == nullptr || beta == nullptr ||
      gamma == nullptr || zeta == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, u, out, nullptr, n, rows(beta, gamma, zeta, cols), 0, 0, dtype,
                stream);
}
