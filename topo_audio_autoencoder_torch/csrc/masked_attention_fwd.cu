// Masked multi-head cross-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_audio_autoencoder_tpu/ops/attention.py:54
// (_attn_kernel, launched by _attn_fwd_call at :80). Same function:
//   out = softmax(mask(q k^T / sqrt(D))) v   per (batch, head),
// with the softmax and the accumulation in fp32, masked keys scored -1e9,
// and a batch element whose mask sums to 0 giving an output of exact zeros.
// In place of the TPU kernel's [B*H, Q, M] weights P it writes the per-row
// log-sum-exp L [B, H, Q] (fp32; +inf for a fully masked element), from
// which a backward can recompute P = exp(s - L).
//
// Layout: q [B, Q, C], k and v [B, M, C], mask [B, M] (fp32), out [B, Q, C],
// all contiguous. Head h owns channels [h*D, (h+1)*D), C = H*D: heads are
// addressed by stride, so no split-heads copy is made.
//
// Design (simple and right first): one block per (64 query rows, head,
// batch element), one thread per query row. A thread keeps its q[D] and
// its accumulator[D] in registers and runs an online (running max / sum)
// softmax over the keys. The block stages 64-key tiles of K and V for its
// head, and the tile's mask, through shared memory. The mask is per batch
// element and shared by every head and row, so the key loop branches
// uniformly: a tile with no active key is skipped after one barrier, and a
// masked key is never loaded or scored. Skipping it is exact, because with
// at least one active key exp(-1e9 - max) is 0 in fp32; the fully masked
// element is zeroed explicitly. Keys past M in the ragged last tile are
// never read.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32
// outside the tensor cores, 3.35 TB/s HBM): at the codec's shape (B=8, H=4,
// Q=250, M=6175, D=16) QK^T and PV are 4*B*H*Q*M*D = 3.2 GFLOP over all
// keys, about 49 M exps, and about 26 MB of fp32 q/K/V/mask to read. The
// bound is operations: 3.2 GFLOP at 67 TFLOP/s is 47 us, against 8 us for
// the bytes. Masked keys cost neither, so a run's bound scales with its
// active keys. What this design leaves on the table: every 64-row query
// block re-reads its head's K and V (4 times at Q=250), each block holds
// only two warps, so the SMs are far from full, and both contractions are
// scalar FMAs on the CUDA cores instead of wgmma / mma.sync on the tensor
// cores. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // query rows per block == threads per block
constexpr int kKeys = 64;  // keys per shared-memory tile (== kRows: one mask entry per thread)

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

template <typename T, int D>
__global__ void __launch_bounds__(kRows) masked_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
    int Q, int M, int H, float scale) {
  __shared__ float k_s[kKeys][D];
  __shared__ float v_s[kKeys][D];
  __shared__ float m_s[kKeys];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < Q;
  const int C = H * D;

  const int64_t q_off = ((int64_t)b * Q + row) * C + (int64_t)h * D;
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    // Pre-scaling q by 1/sqrt(D) is exact for D = 4, 16, 64 (a power of 2).
    qr[d] = live ? to_float(q[q_off + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY;
  float l_run = 0.f;
  int any_active = 0;

  const T* kb = k + (int64_t)b * M * C + (int64_t)h * D;
  const T* vb = v + (int64_t)b * M * C + (int64_t)h * D;
  const float* mb = mask + (int64_t)b * M;

  for (int m0 = 0; m0 < M; m0 += kKeys) {
    const int n = min(kKeys, M - m0);
    const float mk = tid < n ? mb[m0 + tid] : 0.f;
    // Barrier: also ends every thread's reads of the previous tile.
    if (!__syncthreads_or(mk > 0.f)) continue;  // uniform: no active key here
    any_active = 1;
    m_s[tid] = mk;
    for (int e = tid; e < kKeys * D; e += kRows) {
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
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 2) {
          s0 = fmaf(qr[d], k_s[j][d], s0);
          if (d + 1 < D) s1 = fmaf(qr[d + 1], k_s[j][d + 1], s1);
        }
        const float s = s0 + s1;
        if (s > m_run) {
          const float corr = expf(m_run - s);  // 0 on the first active key
          l_run = l_run * corr + 1.f;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(acc[d], corr, v_s[j][d]);
          m_run = s;
        } else {
          const float p = expf(s - m_run);
          l_run += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j][d], acc[d]);
        }
      }
    }
  }

  if (!live) return;
  const int64_t l_off = ((int64_t)b * H + h) * Q + row;
  if (any_active) {
    const float inv = 1.f / l_run;
#pragma unroll
    for (int d = 0; d < D; ++d) out[q_off + d] = from_float<T>(acc[d] * inv);
    lse[l_off] = m_run + logf(l_run);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) out[q_off + d] = from_float<T>(0.f);
    lse[l_off] = INFINITY;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            void* lse, int B, int Q, int M, int H, cudaStream_t stream) {
  const dim3 grid((Q + kRows - 1) / kRows, H, B);
  masked_attention_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), Q,
      M, H, 1.0f / sqrtf((float)D));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, void* out,
             void* lse, int B, int Q, int M, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 2: launch<T, 2>(q, k, v, mask, out, lse, B, Q, M, H, stream); break;
    case 4: launch<T, 4>(q, k, v, mask, out, lse, B, Q, M, H, stream); break;
    case 8: launch<T, 8>(q, k, v, mask, out, lse, B, Q, M, H, stream); break;
    case 16: launch<T, 16>(q, k, v, mask, out, lse, B, Q, M, H, stream); break;
    case 32: launch<T, 32>(q, k, v, mask, out, lse, B, Q, M, H, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess), or cudaErrorInvalidValue for arguments the
// kernel does not take. Launches on `stream` and does not synchronise.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse, int B, int Q,
                                    int M, int C, int H, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Q <= 0 || M < 0 || H <= 0 || H > 65535 || C % H != 0)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, mask, out, lse, B, Q, M, H, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse, B, Q, M, H, D, s);
  return (int)cudaErrorInvalidValue;
}
