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
// Design: a deterministic split over keys, then a merge pass; both dtypes
// compute in fp32 on the CUDA cores.
// - attn_fwd_partial: one block per (256 query rows, head, batch element,
//   split). The keys are cut into S contiguous ranges of whole 64-key
//   windows (split s takes windows [s*T/S, (s+1)*T/S) of T); S is chosen by
//   the caller for about 4 blocks per SM (ops/attention.py, _num_splits).
//   A thread owns R query rows (R = 2 for D <= 16, 1 for D = 32), with q
//   and the accumulator of each in registers, so a block covers 256 rows
//   and stages each K/V window once for all of them. In each window two
//   warps ballot the mask and pack the active keys to the front of the
//   shared tile, in key order; a window with no active key is skipped
//   uniformly and a masked key is never loaded or scored. Skipping it is
//   exact: with at least one active key exp(-1e9 - max) is 0 in fp32. The
//   packed keys are scored in chunks of 16: 16*R scores in registers, one
//   running-max update and one rescale of the accumulator per chunk, then
//   the exps and the PV FMAs. K and V rows are read from shared memory as
//   16-byte vectors, all lanes on one address (a broadcast), each feeding
//   4*R FMAs. Scores are kept in base 2 (q pre-scaled by log2(e)/sqrt(D)),
//   so each weight is one exp2f. The block writes, per row, its split's
//   max m_s, sum l_s and unnormalised accumulator acc_s [D] as fp32
//   partials; a split with no active key writes m_s = -inf, l_s = 0, acc 0.
// - attn_fwd_merge: one thread per (batch, head, row, channel) reads the S
//   partials in split order: m = max m_s, w_s = 2^(m_s - m),
//   O = sum w_s acc_s / sum w_s l_s, L = (m + log2 sum w_s l_s) ln 2;
//   zeros and +inf where m = -inf.
//   No atomics: the same inputs give the same bits on every run.
// The caller allocates the partials (S*B*H*Q*(D+2) floats: acc [S, B, H,
// Q, D], then m and l [S, B, H, Q]); the kernels allocate nothing.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s HBM): QK^T and PV are 4*Q*C FLOP per active key. At the train
// step's shape (B=16, H=4, Q=250, M=6175, D=16, every key active) that is
// 6.3 GFLOP, 94 us at the fp32 peak, against 14 us for the bytes: the
// bound is operations, and masked keys cost neither. Both dtypes use the
// fp32 arithmetic (the train and serve paths run in fp32, where a tensor
// core would mean TF32). What this design leaves on the table: the K/V
// window is loaded synchronously (no cp.async double buffer), a chunk with
// fewer than 16 active keys still scores 16, and bf16 does not use the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 256;  // query rows per block of attn_fwd_partial
constexpr int kKeys = 64;           // keys per window: two warps' ballots
constexpr int kChunk = 16;          // keys scored per rescale of the accumulator
constexpr int kMergeThreads = 128;
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.6931471805599453f;

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

// W consecutive floats from shared memory in one vector load (W = 4 or 2).
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kRowsPerBlock / R) attn_fwd_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, int B, int Q, int M, int H, int S, float scale_log2) {
  constexpr int kThreads = kRowsPerBlock / R;
  constexpr int W = D % 4 == 0 ? 4 : 2;
  __shared__ __align__(16) float k_s[kKeys][D];
  __shared__ __align__(16) float v_s[kKeys][D];
  __shared__ int idx_s[kKeys];
  __shared__ unsigned ballot_s[2];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / S;
  const int split = blockIdx.z % S;
  const int C = H * D;
  const int windows = (M + kKeys - 1) / kKeys;
  const int w_begin = (int)((int64_t)split * windows / S);
  const int w_end = (int)((int64_t)(split + 1) * windows / S);

  float qr[R][D];
  float acc[R][D];
  float m_run[R];
  float l_run[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = blockIdx.x * kRowsPerBlock + i * kThreads + tid;
    const bool live = row < Q;
    const int64_t q_off = ((int64_t)b * Q + row) * C + (int64_t)h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[i][d] = live ? to_float(q[q_off + d]) * scale_log2 : 0.f;
      acc[i][d] = 0.f;
    }
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  const T* kb = k + (int64_t)b * M * C + (int64_t)h * D;
  const T* vb = v + (int64_t)b * M * C + (int64_t)h * D;
  const float* mb = mask + (int64_t)b * M;

  for (int w = w_begin; w < w_end; ++w) {
    const int m0 = w * kKeys;
    const int n = min(kKeys, M - m0);
    bool active = false;
    __syncthreads();  // every thread is done with the previous window's tile
    if (tid < kKeys) {  // warps 0 and 1, whole
      active = tid < n && mb[m0 + tid] > 0.f;
      const unsigned ballot = __ballot_sync(0xffffffffu, active);
      if ((tid & 31) == 0) ballot_s[tid >> 5] = ballot;
    }
    __syncthreads();
    const unsigned b0 = ballot_s[0];
    const unsigned b1 = ballot_s[1];
    const int count = __popc(b0) + __popc(b1);
    if (count == 0) continue;  // uniform: no active key in this window
    if (active) {  // pack the active keys to the front, in key order
      const unsigned below = (tid < 32 ? b0 : b1) & ((1u << (tid & 31)) - 1u);
      idx_s[(tid < 32 ? 0 : __popc(b0)) + __popc(below)] = m0 + tid;
    }
    __syncthreads();
    // Rows past `count` up to the chunk edge are zeros: their scores are
    // replaced by -inf below, and a zero V row keeps 0 * v finite.
    const int padded = (count + kChunk - 1) / kChunk * kChunk;
    for (int e = tid; e < padded * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      float kx = 0.f, vx = 0.f;
      if (r < count) {
        const int64_t off = (int64_t)idx_s[r] * C + c;
        kx = to_float(kb[off]);
        vx = to_float(vb[off]);
      }
      k_s[r][c] = kx;
      v_s[r][c] = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < count; j0 += kChunk) {
      float p[R][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int i = 0; i < R; ++i) p[i][jj] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += W) {
          float kx[W];
          load_vec<W>(&k_s[j0 + jj][d], kx);
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int x = 0; x < W; ++x) p[i][jj] = fmaf(qr[i][d + x], kx[x], p[i][jj]);
          }
        }
      }
      const int live_keys = count - j0;  // >= 1; chunk slots from here on are padding
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float chunk_max = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          if (jj >= live_keys) p[i][jj] = -INFINITY;
          chunk_max = fmaxf(chunk_max, p[i][jj]);
        }
        const float m_new = fmaxf(m_run[i], chunk_max);  // finite: slot 0 is live
        const float corr = exp2f(m_run[i] - m_new);        // 0 before the first key
        m_run[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          p[i][jj] = exp2f(p[i][jj] - m_new);
          sum += p[i][jj];
        }
        l_run[i] = fmaf(l_run[i], corr, sum);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[i][d] *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int d = 0; d < D; d += W) {
          float vx[W];
          load_vec<W>(&v_s[j0 + jj][d], vx);
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int x = 0; x < W; ++x) acc[i][d + x] = fmaf(p[i][jj], vx[x], acc[i][d + x]);
          }
        }
      }
    }
  }

  const int64_t rows = (int64_t)B * H * Q;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = blockIdx.x * kRowsPerBlock + i * kThreads + tid;
    if (row >= Q) continue;
    const int64_t idx = split * rows + ((int64_t)b * H + h) * Q + row;
    part_m[idx] = m_run[i];
    part_l[idx] = l_run[i];
#pragma unroll
    for (int d = 0; d < D; ++d) part_acc[idx * D + d] = acc[i][d];
  }
}

// One thread per (batch, head, row, channel): the D threads of a row read
// its m_s and l_s at one address each (a broadcast) and neighbouring
// channels of acc_s, so every load of the S splits is coalesced.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads) attn_fwd_merge(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, T* __restrict__ out, float* __restrict__ lse, int B, int Q,
    int H, int S) {
  const int64_t rows = (int64_t)B * H * Q;
  const int64_t e = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= rows * D) return;
  const int d = (int)(e % D);
  const int64_t idx = e / D;  // (b, h, row)
  const int row = (int)(idx % Q);
  const int64_t bh = idx / Q;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  const int64_t o_off = (b * Q + row) * (int64_t)(H * D) + (int64_t)h * D + d;

  float m = -INFINITY;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part_m[s * rows + idx]);
  if (m == -INFINITY) {  // no active key in the whole element
    out[o_off] = from_float<T>(0.f);
    if (d == 0) lse[idx] = INFINITY;
    return;
  }
  float l = 0.f;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {  // in split order: the same sum on every run
    const int64_t p = s * rows + idx;
    const float w = exp2f(part_m[p] - m);  // 0 for a split with no active key
    l = fmaf(w, part_l[p], l);
    acc = fmaf(w, part_acc[p * D + d], acc);
  }
  out[o_off] = from_float<T>(acc / l);
  if (d == 0) lse[idx] = (m + log2f(l)) * kLn2;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
           void* work, int B, int Q, int M, int H, int S, cudaStream_t stream) {
  constexpr int R = D <= 16 ? 2 : 1;
  const int64_t rows = (int64_t)B * H * Q;
  float* part_acc = static_cast<float*>(work);
  float* part_m = part_acc + S * rows * D;
  float* part_l = part_m + S * rows;
  const dim3 grid((Q + kRowsPerBlock - 1) / kRowsPerBlock, H, B * S);
  attn_fwd_partial<T, D, R><<<grid, kRowsPerBlock / R, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), part_acc, part_m, part_l, B, Q, M, H, S,
      (float)(kLog2e / sqrt((double)D)));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t merge_blocks = (rows * D + kMergeThreads - 1) / kMergeThreads;
  attn_fwd_merge<T, D><<<(unsigned)merge_blocks, kMergeThreads, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), static_cast<float*>(lse), B, Q, H, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
             void* work, int B, int Q, int M, int H, int D, int S, cudaStream_t stream) {
  switch (D) {
    case 2: return launch<T, 2>(q, k, v, mask, out, lse, work, B, Q, M, H, S, stream);
    case 4: return launch<T, 4>(q, k, v, mask, out, lse, work, B, Q, M, H, S, stream);
    case 8: return launch<T, 8>(q, k, v, mask, out, lse, work, B, Q, M, H, S, stream);
    case 16: return launch<T, 16>(q, k, v, mask, out, lse, work, B, Q, M, H, S, stream);
    case 32: return launch<T, 32>(q, k, v, mask, out, lse, work, B, Q, M, H, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `work` holds S*B*H*Q*(D+2) floats of
// partials, S the number of splits over keys (1 <= S, B*S <= 65535).
// Returns cudaGetLastError() after the launches (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernels do not take. Launches on
// `stream` and does not synchronise.
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, void* lse, void* work, int B,
                                    int Q, int M, int C, int H, int S, int dtype, void* stream) {
  if (B <= 0 || Q <= 0 || M < 0 || H <= 0 || H > 65535 || C % H != 0 || S <= 0 ||
      (int64_t)B * S > 65535)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, mask, out, lse, work, B, Q, M, H, D, S, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse, work, B, Q, M, H, D, S, s);
  return (int)cudaErrorInvalidValue;
}
