// Hard Concrete gates with their own random numbers, and their backward,
// for Hopper (sm_90a).
//
// Replaces two TPU kernels of topo_audio_autoencoder_tpu/ops/pallas_kernels.py:
//   - :61  _hard_concrete_kernel (launched by _hard_concrete_pallas_call at
//     :81): a fixed stretch, T, gamma and zeta scalars;
//   - :127 _hard_concrete_learned_kernel (launched by
//     _hard_concrete_learned_pallas_call at :149): per-simplex rows beta
//     (in place of T), gamma and zeta, element i of a [B, S] log-alpha
//     reading column i % S;
// and the closed-form VJPs that XLA fuses into one pass each there
// (_hc_bwd at :317, _hcl_bwd at :367).
//
// Forward: one elementwise pass over log-alpha a (n elements), fp32
// inside, output z in a's dtype, in the plain version's order of operations
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
// reproduces bit for bit, from element `first` of the stream (a
// data-parallel rank's rows of the global batch's draw; 0 for the whole
// draw, the bits from before `first` existed). An even `first` keeps each
// thread's two elements in one group; an odd one puts the pair of every
// other thread across two groups, and that thread computes both blocks.
// Each variant has a second entry point that reads the uniforms from a
// tensor (how the tests hand both packages the same numbers). The TPU kernels pad log-alpha to (8, 128) tiles and the
// stretch rows with 1/0/1; here nothing is padded: a thread masks the
// ragged end itself.
//
// Backward, from the gate z alone (the plain versions'
// hard_concrete_bwd_plain and hard_concrete_learned_bwd_plain, in their
// order of operations): s = clip((z - gamma) / (zeta - gamma), 1e-6,
// 1 - 1e-6) and the mask of unclipped gates give da, and for learned rows
// the batch's column sums of the stretch cotangents dbeta, dgamma, dzeta.
// A column's sum runs in a fixed order, without atomics: a block holds
// 256 / P columns and P row slices (P the largest power of two <= min(16,
// rows)); slice k adds its contiguous rows in order, then one thread per
// column adds the P partials in slice order. Two calls give the same bits.
//
// What bounds them on an H100 SXM: neither bytes nor operations but the
// launch. Per element the forward reads one log-alpha and writes one gate
// (8 bytes in fp32), plus the three fp32 stretch rows once for the learned
// variant, for about 45 operations (a quarter of a Philox block, log,
// log1p, exp, a divide, the stretch and the clip); at 3.35 TB/s the
// [32, 6195] gates of a train step move in under half a microsecond, while
// an empty kernel takes ~0.9 us of device time. So the forward runs two
// elements per thread, half a Philox group: each thread computes its
// group's block and keeps its two words, with its log-alpha (one 8-byte
// fp32 or 4-byte bf16 access) in flight during the rounds. One element per
// thread, binary_gumbel.cu's mapping, measured 0.3-0.4 us slower at the
// fixed stretch's [32, 6195] and ~0.1 us slower at the learned [16, 6195].
// One group per thread with one 16-byte access measured ~0.1 us faster at
// the fixed stretch's shape and slower at the learned one; the template
// keeps one mapping for both (PERF.md). The backward is one launch where
// the plain versions are chains of 12 (fixed) and 32 (learned) launches,
// and its column sums use up to 16 slices so that a train step's 16 rows
// give one row a thread.

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

  __device__ __forceinline__ float3 col(int64_t c) const {
    if (beta == nullptr) return make_float3(t, g, z);
    return make_float3(beta[c], gamma[c], zeta[c]);
  }
  // Elements base .. base+kPer-1: one modulo, then the next columns.
  template <int E>
  __device__ __forceinline__ void at(int64_t base, int64_t n, float3 p[E]) const {
    int64_t c = beta == nullptr ? 0 : base % cols;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      p[j] = base + j < n ? col(c) : make_float3(1.0f, 0.0f, 1.0f);
      if (beta != nullptr && ++c == cols) c = 0;
    }
  }
};

// Elements per thread: half a Philox group (see the note at the top).
constexpr int kPer = 2;
constexpr int kThreads = 128;

// Thread t: elements kPer t .. kPer t + kPer - 1, read and written in one
// access each where whole and aligned; element i takes stream element
// first + i, word (first + i) & 3 of group (first + i) / 4.
template <typename T>
__global__ void __launch_bounds__(kThreads) philox_kernel(const T* __restrict__ log_alpha,
                                                          T* __restrict__ out,
                                                          float* __restrict__ u_out, int64_t n,
                                                          Stretch st, uint64_t first,
                                                          uint32_t seed_lo, uint32_t seed_hi,
                                                          uint32_t off_lo, uint32_t off_hi,
                                                          bool aligned_io) {
  const int64_t base = kPer * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (base >= n) return;
  const bool whole = aligned_io && base + kPer <= n;
  float a[kPer], u[kPer], z[kPer];
  float3 p[kPer];
  load<kPer>(log_alpha, base, n, whole, a);  // in flight during the Philox rounds
  st.at<kPer>(base, n, p);
  const uint64_t e = first + (uint64_t)base;
  const int w0 = (int)(e & 3);
  const uint4 r = philox_block((int64_t)(e >> 2), seed_lo, seed_hi, off_lo, off_hi);
  // The next group's block, only where the pair crosses into it (odd first).
  const uint4 r1 =
      w0 + kPer > 4 ? philox_block((int64_t)(e >> 2) + 1, seed_lo, seed_hi, off_lo, off_hi) : r;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int k = w0 + j;
    u[j] = bits_to_uniform(k < 4 ? word(r, k) : word(r1, k - 4));
    z[j] = gate(a[j], u[j], p[j].x, p[j].y, p[j].z);
  }
  store<kPer>(out, base, n, whole, z);
  if (u_out != nullptr) store<kPer>(u_out, base, n, whole, u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) noise_kernel(const T* __restrict__ log_alpha,
                                                         const float* __restrict__ u,
                                                         T* __restrict__ out, int64_t n,
                                                         Stretch st, bool aligned_io) {
  const int64_t base = kPer * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (base >= n) return;
  const bool whole = aligned_io && base + kPer <= n;
  float a[kPer], uu[kPer], z[kPer];
  float3 p[kPer];
  load<kPer>(log_alpha, base, n, whole, a);
  load<kPer>(u, base, n, whole, uu);
  st.at<kPer>(base, n, p);
#pragma unroll
  for (int j = 0; j < kPer; ++j) z[j] = gate(a[j], uu[j], p[j].x, p[j].y, p[j].z);
  store<kPer>(out, base, n, whole, z);
}

// The backward's block, and the most row slices it splits its columns'
// rows into.
constexpr int kBwdThreads = 256;
constexpr int kMaxSlices = 16;

// The backward over z viewed as [rows, cols]: blockDim = (256 / P, P),
// thread (x, k) owns column blockIdx.x * blockDim.x + x and rows k * chunk
// .. (k + 1) * chunk - 1 (chunk = ceil(rows / P)).
// Fixed stretch (st.beta == nullptr): da = ct * (1{0<z<1} s (1 - s) scale),
// scale = (zeta - gamma) / T in training, zeta - gamma in eval; no sums
// (dgamma == nullptr). Learned rows:
//   da     = ct sp (zeta - gamma) / beta        (eval: no / beta)
//   dbeta  = sum ct sp (zeta - gamma) (-logit s) / beta   (eval: 0)
//   dgamma = sum ct 1{0<z<1} (1 - s),   dzeta = sum ct 1{0<z<1} s
// with sp = 1{0<z<1} s (1 - s), each product rounded on its own.
template <typename T, typename C>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_kernel(const T* __restrict__ z, const C* __restrict__ ct, T* __restrict__ da,
               float* __restrict__ dbeta, float* __restrict__ dgamma, float* __restrict__ dzeta,
               int64_t rows, int64_t cols, int64_t chunk, Stretch st, float scale, int training) {
  const int x = threadIdx.x, k = threadIdx.y;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + x;
  const int64_t r0 = k * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float sum_b = 0.0f, sum_g = 0.0f, sum_z = 0.0f;
  if (c < cols) {
    const float3 p = st.col(c);
    const float span = __fsub_rn(p.z, p.y);
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * cols + c;
      const float zf = to_float(z[i]);
      const float cf = to_float(ct[i]);
      const float s = fminf(fmaxf(__fdiv_rn(__fsub_rn(zf, p.y), span), 1e-6f), 1.0f - 1e-6f);
      const float inside = (zf > 0.0f && zf < 1.0f) ? 1.0f : 0.0f;
      const float sp = __fmul_rn(__fmul_rn(inside, s), __fsub_rn(1.0f, s));
      if (st.beta == nullptr) {
        da[i] = from_float<T>(__fmul_rn(cf, __fmul_rn(sp, scale)));
        continue;
      }
      const float ctsp_span = __fmul_rn(__fmul_rn(cf, sp), span);
      if (training) {
        da[i] = from_float<T>(__fdiv_rn(ctsp_span, p.x));
        const float logit = __fsub_rn(logf(s), log1pf(-s));
        sum_b = __fadd_rn(sum_b, __fdiv_rn(__fmul_rn(ctsp_span, -logit), p.x));
      } else {
        da[i] = from_float<T>(ctsp_span);
      }
      const float ct_in = __fmul_rn(cf, inside);
      sum_g = __fadd_rn(sum_g, __fmul_rn(ct_in, __fsub_rn(1.0f, s)));
      sum_z = __fadd_rn(sum_z, __fmul_rn(ct_in, s));
    }
  }
  if (dgamma == nullptr) return;  // the same for every thread of the grid
  __shared__ float part[3][kBwdThreads];
  const int slot = k * blockDim.x + x;
  part[0][slot] = sum_b;
  part[1][slot] = sum_g;
  part[2][slot] = sum_z;
  __syncthreads();
  if (k != 0 || c >= cols) return;
  float b = 0.0f, g = 0.0f, zz = 0.0f;
  for (int j = 0; j < (int)blockDim.y; ++j) {
    b = __fadd_rn(b, part[0][j * blockDim.x + x]);
    g = __fadd_rn(g, part[1][j * blockDim.x + x]);
    zz = __fadd_rn(zz, part[2][j * blockDim.x + x]);
  }
  dbeta[c] = b;
  dgamma[c] = g;
  dzeta[c] = zz;
}

int launch(const void* log_alpha, const void* u, void* out, void* u_out, int64_t n,
           const Stretch& st, uint64_t seed, uint64_t offset, uint64_t first, int dtype,
           void* stream) {
  if (first > UINT64_MAX - (uint64_t)n) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(((n + kPer - 1) / kPer + kThreads - 1) / kThreads);
  if (u == nullptr) {
    const uint32_t slo = (uint32_t)seed, shi = (uint32_t)(seed >> 32);
    const uint32_t olo = (uint32_t)offset, ohi = (uint32_t)(offset >> 32);
    if (dtype == 0) {
      philox_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(log_alpha), static_cast<float*>(out),
          static_cast<float*>(u_out), n, st, first, slo, shi, olo, ohi,
          aligned<kPer, float>(log_alpha) && aligned<kPer, float>(out) && aligned<kPer, float>(u_out));
    } else if (dtype == 1) {
      philox_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(log_alpha), static_cast<__nv_bfloat16*>(out),
          static_cast<float*>(u_out), n, st, first, slo, shi, olo, ohi,
          aligned<kPer, __nv_bfloat16>(log_alpha) && aligned<kPer, __nv_bfloat16>(out) &&
              aligned<kPer, float>(u_out));
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    if (dtype == 0) {
      noise_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(log_alpha), static_cast<const float*>(u),
          static_cast<float*>(out), n, st,
          aligned<kPer, float>(log_alpha) && aligned<kPer, float>(u) && aligned<kPer, float>(out));
    } else if (dtype == 1) {
      noise_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(log_alpha), static_cast<const float*>(u),
          static_cast<__nv_bfloat16*>(out), n, st,
          aligned<kPer, __nv_bfloat16>(log_alpha) && aligned<kPer, float>(u) &&
              aligned<kPer, __nv_bfloat16>(out));
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// The backward's row slices: the largest power of two <= min(kMaxSlices, rows).
int slices_for(int64_t rows) {
  int p = 1;
  while (p < kMaxSlices && 2 * p <= rows) p *= 2;
  return p;
}

template <typename T, typename C>
void launch_bwd_as(const void* z, const void* ct, void* da, float* dbeta, float* dgamma,
                   float* dzeta, int64_t rows, int64_t cols, const Stretch& st, float scale,
                   int training, cudaStream_t s) {
  const int p = slices_for(rows);
  const dim3 block(kBwdThreads / p, p);
  const unsigned blocks = (unsigned)((cols + block.x - 1) / block.x);
  bwd_kernel<T, C><<<blocks, block, 0, s>>>(static_cast<const T*>(z), static_cast<const C*>(ct),
                                            static_cast<T*>(da), dbeta, dgamma, dzeta, rows, cols,
                                            (rows + p - 1) / p, st, scale, training);
}

int launch_bwd(const void* z, const void* ct, void* da, void* dbeta, void* dgamma, void* dzeta,
               int64_t rows, int64_t cols, const Stretch& st, float scale, int training,
               int dtype, int ct_dtype, void* stream) {
  if (cols == 0) return (int)cudaSuccess;  // no rows still writes the sums: zeros
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(dbeta);
  float* g = static_cast<float*>(dgamma);
  float* zz = static_cast<float*>(dzeta);
  if (dtype == 0 && ct_dtype == 0) {
    launch_bwd_as<float, float>(z, ct, da, b, g, zz, rows, cols, st, scale, training, s);
  } else if (dtype == 0 && ct_dtype == 1) {
    launch_bwd_as<float, __nv_bfloat16>(z, ct, da, b, g, zz, rows, cols, st, scale, training, s);
  } else if (dtype == 1 && ct_dtype == 0) {
    launch_bwd_as<__nv_bfloat16, float>(z, ct, da, b, g, zz, rows, cols, st, scale, training, s);
  } else if (dtype == 1 && ct_dtype == 1) {
    launch_bwd_as<__nv_bfloat16, __nv_bfloat16>(z, ct, da, b, g, zz, rows, cols, st, scale,
                                                 training, s);
  } else {
    return (int)cudaErrorInvalidValue;
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

// Fixed stretch, uniforms from (seed, offset) starting at stream element
// `first`; u_out (may be null) receives them.
extern "C" int hard_concrete_philox(const void* log_alpha, void* out, void* u_out, int64_t n,
                                    uint64_t seed, uint64_t offset, uint64_t first,
                                    float temperature, float gamma, float zeta, int dtype,
                                    void* stream) {
  if (n < 0 || !(temperature > 0.0f) || !(zeta > gamma)) return (int)cudaErrorInvalidValue;
  return launch(log_alpha, nullptr, out, u_out, n, fixed(temperature, gamma, zeta), seed, offset,
                first, dtype, stream);
}

// Fixed stretch on given uniforms u (n elements).
extern "C" int hard_concrete_noise(const void* log_alpha, const void* u, void* out, int64_t n,
                                   float temperature, float gamma, float zeta, int dtype,
                                   void* stream) {
  if (n < 0 || u == nullptr || !(temperature > 0.0f) || !(zeta > gamma))
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, u, out, nullptr, n, fixed(temperature, gamma, zeta), 0, 0, 0, dtype,
                stream);
}

// Learned stretch: beta, gamma, zeta are [cols] rows; n is a multiple of
// cols; the uniforms start at stream element `first`.
extern "C" int hard_concrete_learned_philox(const void* log_alpha, const void* beta,
                                            const void* gamma, const void* zeta, void* out,
                                            void* u_out, int64_t n, int64_t cols, uint64_t seed,
                                            uint64_t offset, uint64_t first, int dtype,
                                            void* stream) {
  if (n < 0 || cols <= 0 || n % cols != 0 || beta == nullptr || gamma == nullptr ||
      zeta == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, nullptr, out, u_out, n, rows(beta, gamma, zeta, cols), seed, offset,
                first, dtype, stream);
}

// Learned stretch on given uniforms u (n elements).
extern "C" int hard_concrete_learned_noise(const void* log_alpha, const void* u,
                                           const void* beta, const void* gamma, const void* zeta,
                                           void* out, int64_t n, int64_t cols, int dtype,
                                           void* stream) {
  if (n < 0 || cols <= 0 || n % cols != 0 || u == nullptr || beta == nullptr ||
      gamma == nullptr || zeta == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(log_alpha, u, out, nullptr, n, rows(beta, gamma, zeta, cols), 0, 0, 0, dtype,
                stream);
}

// The fixed stretch's backward over n gates: da = ct * (1{0<z<1} s (1 - s)
// scale), scale = (zeta - gamma) / T in training and zeta - gamma in eval
// (the caller rounds it to fp32 from the double). dtype is z's and da's,
// ct_dtype the cotangent's.
extern "C" int hard_concrete_bwd(const void* z, const void* ct, void* da, int64_t n, float gamma,
                                 float zeta, float scale, int training, int dtype, int ct_dtype,
                                 void* stream) {
  if (n < 0 || !(zeta > gamma)) return (int)cudaErrorInvalidValue;
  return launch_bwd(z, ct, da, nullptr, nullptr, nullptr, 1, n, fixed(1.0f, gamma, zeta), scale,
                    training, dtype, ct_dtype, stream);
}

// The learned stretch's backward: z and ct are [n / cols, cols], beta,
// gamma and zeta [cols] rows; da like z, and dbeta, dgamma, dzeta [cols]
// fp32 column sums (dbeta 0 in eval).
extern "C" int hard_concrete_learned_bwd(const void* z, const void* ct, const void* beta,
                                         const void* gamma, const void* zeta, void* da,
                                         void* dbeta, void* dgamma, void* dzeta, int64_t n,
                                         int64_t cols, int training, int dtype, int ct_dtype,
                                         void* stream) {
  if (n < 0 || cols <= 0 || n % cols != 0 || beta == nullptr || gamma == nullptr ||
      zeta == nullptr || dbeta == nullptr || dgamma == nullptr || dzeta == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_bwd(z, ct, da, dbeta, dgamma, dzeta, n / cols, cols, rows(beta, gamma, zeta, cols),
                    0.0f, training, dtype, ct_dtype, stream);
}
