// Philox4x32-10, the conversions and the element access shared by the
// sampler kernels (binary_gumbel.cu, hard_concrete.cu).
//
// The generator is Philox4x32-10 (Salmon et al., SC'11), keyed by the
// 64-bit seed; the 128-bit counter is (group index, 64-bit offset). Group g
// covers elements 4g .. 4g+3 of the stream; a draw of n elements from
// element `first` (a data-parallel rank's rows of the global batch's draw;
// 0 for the whole batch) gives its element i element first + i, word
// (first + i) & 3 of group (first + i) >> 2. Word j of a block becomes
// u = (word_j >> 8) * 2^-24, clipped to [1e-6, 1 - 1e-6]. The shift is on
// unsigned 32-bit words: the TPU kernels' bits were signed, and an
// arithmetic shift once skewed their uniforms into (0, 0.5)
// (topo_audio_autoencoder_tpu/ops/pallas_kernels.py:37-48).
// ops/fused_samplers.py::philox_uniform computes the same words in plain
// torch, and the two agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sampler {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10: ten rounds, the key bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * ctr.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
    const uint32_t lo1 = kPhiloxM1 * ctr.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// The block of group g under (seed, offset), split into 32-bit halves.
__device__ __forceinline__ uint4 philox_block(int64_t g, uint32_t seed_lo, uint32_t seed_hi,
                                              uint32_t off_lo, uint32_t off_hi) {
  return philox4x32_10(
      make_uint4((uint32_t)g, (uint32_t)((uint64_t)g >> 32), off_lo, off_hi), seed_lo, seed_hi);
}

// Word k (0-3) of a Philox block. Selects, not an indexed array, so the
// block stays in registers.
__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// E consecutive elements of T as one access of E * sizeof(T) bytes.
template <typename T, int E>
struct alignas(E * sizeof(T)) Pack {
  T v[E];
};

// Elements base .. base+E-1 of p (those below n) as fp32, in one access
// where `whole` (all E below n, p aligned to the access).
template <int E, typename T>
__device__ __forceinline__ void load(const T* p, int64_t base, int64_t n, bool whole, float v[E]) {
  if (whole) {
    const Pack<T, E> x = *reinterpret_cast<const Pack<T, E>*>(p + base);
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = to_float(x.v[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = base + j < n ? to_float(p[base + j]) : 0.0f;
}

// Writes v[0 .. E-1] to elements base .. base+E-1 of p (those below n), as load.
template <int E, typename T>
__device__ __forceinline__ void store(T* p, int64_t base, int64_t n, bool whole, const float v[E]) {
  if (whole) {
    Pack<T, E> x;
#pragma unroll
    for (int j = 0; j < E; ++j) x.v[j] = from_float<T>(v[j]);
    *reinterpret_cast<Pack<T, E>*>(p + base) = x;
    return;
  }
#pragma unroll
  for (int j = 0; j < E; ++j)
    if (base + j < n) p[base + j] = from_float<T>(v[j]);
}

// Whether p (or no pointer) may be accessed E elements of T at a time.
template <int E, typename T>
inline bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % (E * sizeof(T)) == 0;
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);  // logical shift: unsigned
  return fminf(fmaxf(u, 1e-6f), 1.0f - 1e-6f);
}

// A standard logistic sample from a uniform: log u - log(1 - u).
__device__ __forceinline__ float logistic(float u) { return logf(u) - log1pf(-u); }

}  // namespace sampler
