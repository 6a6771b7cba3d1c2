// Masked multi-head cross-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_audio_autoencoder_tpu/ops/attention.py:122
// (_attn_bwd_kernel, launched by _attn_bwd_call at :182). Same function:
// given dO, the gradients dq, dk, dv of
//   out = softmax(mask(q k^T / sqrt(D))) v   per (batch, head),
// through the softmax VJP ds = p (dp - sum_j p dp), with p recomputed here
// as exp(s - L) from the forward's per-row log-sum-exp L (fp32, +inf for a
// fully masked batch element) instead of read from a saved [B*H, Q, M] P.
// Masked keys weigh exactly 0: their dk and dv rows are written as exact
// zeros, and a fully masked element gets all-zero dq, dk and dv.
//
// Layout: q, out, dout, dq [B, Q, C]; k, v, dk, dv [B, M, C]; mask [B, M]
// (fp32); lse and the scratch delta [B, H, Q] (fp32); all contiguous. Head
// h owns channels [h*D, (h+1)*D), C = H*D.
//
// Three launches on one stream, each with one thread per row:
// 1. delta_kernel: delta_i = dO_i . O_i per (row, head). It equals
//    sum_j p_ij dp_ij, the row sum of the softmax VJP.
// 2. dkdv_kernel: one block per (64-key tile, head, batch element), one
//    thread per key. A tile with no active key writes zeros and returns.
//    Otherwise the block loops over all 64-row query tiles, staging
//    q * scale, dO, L and delta in shared memory; each active key's thread
//    recomputes p = exp(s - L), dp = dO . v, ds = p (dp - delta) and
//    accumulates dv += p dO, dk += ds q * scale in registers.
// 3. dq_kernel: one block per (64 query rows, head, batch element), one
//    thread per row, looping over the active 64-key tiles as the forward
//    does: dq_i = scale * sum_j ds_ij k_j.
// Every output element is written by exactly one thread: no atomics, and
// the result does not depend on the order in which blocks run. The TPU
// kernel's in-place accumulation of dk/dv over its sequential q-block axis
// is replaced by the loop over query tiles inside a dk/dv block.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 989 TFLOP/s bf16 tensor, 3.35 TB/s HBM): the function needs S, dP, dV,
// dK and dQ for every active key and every query row of its element, 2D
// FLOP each per head: about 10 Q C FLOP per active key over all heads.
// This design does 14 Q C (the dq pass forms S and dP again). The bytes it
// must move are q, O, dO, dq ([B, Q, C] each), the active rows of k, v, dk
// and dv, the mask and L. At the train step's shapes (Q=250, C=64) the
// operations bound it; chip_smoke.py computes which bound holds from each
// run's inputs.
// What this simple design leaves: the scores are recomputed in both
// passes; every key block re-reads its element's queries; blocks hold two
// warps; the contractions are scalar FMAs on the CUDA cores, not wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows per block == threads per block == keys or queries per tile

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

// delta[b, h, i] = sum_d dO[b, i, h*D + d] * O[b, i, h*D + d], one thread per (b, i, h).
template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const T* __restrict__ out,
                                                    const T* __restrict__ dout,
                                                    float* __restrict__ delta, int B, int Q,
                                                    int H) {
  const int64_t n = (int64_t)B * Q * H;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int h = (int)(idx % H);
  const int64_t bi = idx / H;  // b * Q + i
  const int i = (int)(bi % Q);
  const int b = (int)(bi / Q);
  const int64_t off = bi * (int64_t)(H * D) + (int64_t)h * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(to_float(dout[off + d]), to_float(out[off + d]), acc);
  delta[((int64_t)b * H + h) * Q + i] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Q, int M, int H,
    float scale) {
  __shared__ float q_s[kTile][D];  // q * scale
  __shared__ float do_s[kTile][D];
  __shared__ float l_s[kTile];
  __shared__ float d_s[kTile];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key = blockIdx.x * kTile + tid;
  const int C = H * D;
  const bool in_range = key < M;
  const bool active = in_range && mask[(int64_t)b * M + key] > 0.f;
  const int64_t kv_off = ((int64_t)b * M + key) * C + (int64_t)h * D;

  if (!__syncthreads_or(active)) {  // uniform: no active key in this tile
    if (in_range) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dk[kv_off + d] = from_float<T>(0.f);
        dv[kv_off + d] = from_float<T>(0.f);
      }
    }
    return;
  }

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = active ? to_float(k[kv_off + d]) : 0.f;
    vr[d] = active ? to_float(v[kv_off + d]) : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const T* qb = q + (int64_t)b * Q * C + (int64_t)h * D;
  const T* dob = dout + (int64_t)b * Q * C + (int64_t)h * D;
  const float* lb = lse + ((int64_t)b * H + h) * Q;
  const float* db = delta + ((int64_t)b * H + h) * Q;

  for (int i0 = 0; i0 < Q; i0 += kTile) {
    const int n = min(kTile, Q - i0);
    __syncthreads();  // every thread is done with the previous query tile
    for (int e = tid; e < kTile * D; e += kTile) {
      const int r = e / D;
      const int c = e % D;
      const bool load = r < n;
      const int64_t off = (int64_t)(i0 + r) * C + c;
      q_s[r][c] = load ? to_float(qb[off]) * scale : 0.f;
      do_s[r][c] = load ? to_float(dob[off]) : 0.f;
    }
    // A row past Q gets L = +inf, so its p is exactly 0.
    l_s[tid] = tid < n ? lb[i0 + tid] : INFINITY;
    d_s[tid] = tid < n ? db[i0 + tid] : 0.f;
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[i][d], kr[d], s);
        dp = fmaf(do_s[i][d], vr[d], dp);
      }
      const float p = expf(s - l_s[i]);
      const float ds = p * (dp - d_s[i]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(p, do_s[i][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, q_s[i][d], dk_acc[d]);  // q_s holds q * scale
      }
    }
  }

  if (!in_range) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[kv_off + d] = from_float<T>(active ? dk_acc[d] : 0.f);
    dv[kv_off + d] = from_float<T>(active ? dv_acc[d] : 0.f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dq, int Q, int M, int H, float scale) {
  __shared__ float k_s[kTile][D];
  __shared__ float v_s[kTile][D];
  __shared__ float m_s[kTile];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kTile + tid;
  const bool live = row < Q;
  const int C = H * D;

  const int64_t q_off = ((int64_t)b * Q + row) * C + (int64_t)h * D;
  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? to_float(q[q_off + d]) * scale : 0.f;
    dor[d] = live ? to_float(dout[q_off + d]) : 0.f;
    acc[d] = 0.f;
  }
  const int64_t l_off = ((int64_t)b * H + h) * Q + row;
  // A fully masked element has L = +inf; it never reaches the key loop
  // below (no tile has an active key), so no inf - inf is formed.
  const float l_row = live ? lse[l_off] : INFINITY;
  const float d_row = live ? delta[l_off] : 0.f;

  const T* kb = k + (int64_t)b * M * C + (int64_t)h * D;
  const T* vb = v + (int64_t)b * M * C + (int64_t)h * D;
  const float* mb = mask + (int64_t)b * M;

  for (int m0 = 0; m0 < M; m0 += kTile) {
    const int n = min(kTile, M - m0);
    const float mk = tid < n ? mb[m0 + tid] : 0.f;
    // Barrier: also ends every thread's reads of the previous tile.
    if (!__syncthreads_or(mk > 0.f)) continue;  // uniform: no active key here
    m_s[tid] = mk;
    for (int e = tid; e < kTile * D; e += kTile) {
      const int r = e / D;
      const int c = e % D;
      const bool load = r < n && mb[m0 + r] > 0.f;
      const int64_t off = (int64_t)(m0 + r) * C + c;
      k_s[r][c] = load ? to_float(kb[off]) : 0.f;
      v_s[r][c] = load ? to_float(vb[off]) : 0.f;
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < n; ++j) {
        if (!(m_s[j] > 0.f)) continue;  // the same j for every thread: uniform
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], k_s[j][d], s);
          dp = fmaf(dor[d], v_s[j][d], dp);
        }
        const float ds = expf(s - l_row) * (dp - d_row);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k_s[j][d], acc[d]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) dq[q_off + d] = from_float<T>(acc[d] * scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* out,
           const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
           int Q, int M, int H, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const int64_t rows = (int64_t)B * Q * H;
  const int threads = 256;
  delta_kernel<T, D><<<(unsigned)((rows + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(delta), B, Q,
      H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (M > 0) {
    const dim3 kgrid((M + kTile - 1) / kTile, H, B);
    dkdv_kernel<T, D><<<kgrid, kTile, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dk),
        static_cast<T*>(dv), Q, M, H, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 qgrid((Q + kTile - 1) / kTile, H, B);
  dq_kernel<T, D><<<qgrid, kTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dq), Q, M,
      H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, const void* out,
             const void* lse, const void* dout, void* delta, void* dq, void* dk, void* dv, int B,
             int Q, int M, int H, int D, cudaStream_t s) {
  switch (D) {
    case 2: return launch<T, 2>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, s);
    case 4: return launch<T, 4>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, s);
    case 8: return launch<T, 8>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, s);
    case 16: return launch<T, 16>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `delta` is fp32 scratch of [B, H, Q]
// floats. Returns the first non-zero cudaGetLastError() of the three
// launches (0 = cudaSuccess), or cudaErrorInvalidValue for arguments the
// kernels do not take. Launches on `stream` and does not synchronise.
extern "C" int masked_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* mask, const void* out, const void* lse,
                                    const void* dout, void* delta, void* dq, void* dk, void* dv,
                                    int B, int Q, int M, int C, int H, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Q <= 0 || M < 0 || H <= 0 || H > 65535 || C % H != 0)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M, H, D, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse, dout, delta, dq, dk, dv, B, Q, M,
                                   H, D, s);
  return (int)cudaErrorInvalidValue;
}
