// Masked multi-head cross-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_audio_autoencoder_tpu/ops/attention.py:122
// (_attn_bwd_kernel, launched by _attn_bwd_call at :182). Same function:
// given dO, the gradients dq, dk, dv of
//   out = softmax(mask(q k^T / sqrt(D))) v   per (batch, head),
// through the softmax VJP ds = p (dp - delta), delta_i = dO_i . O_i (which
// equals sum_j p_ij dp_ij), with p recomputed here as exp(s - L) from the
// forward's per-row log-sum-exp L (fp32, +inf for a fully masked batch
// element) instead of read from a saved [B*H, Q, M] P. Accumulation is in
// fp32 for both dtypes. Masked keys weigh exactly 0: their dk and dv rows
// are written as exact zeros, and a fully masked element gets all-zero dq,
// dk and dv.
//
// Layout: q, out, dout, dq [B, Q, C]; k, v, dk, dv [B, M, C]; mask [B, M]
// (fp32); lse and the scratch delta [B, H, Q] (fp32); all contiguous, rows
// 16-byte aligned at their start. Head h owns channels [h*D, (h+1)*D),
// C = H*D.
//
// Four launches on one stream; every output element is written by exactly
// one thread and every sum is taken in a fixed order, so two calls on the
// same inputs give the same bits (no atomics).
// 1. attn_bwd_delta: delta_i = dO_i . O_i per (row, head), one fmaf chain
//    over d ascending from 0. A single active key has O = v_j exactly, so
//    dp_ij - delta_i is an exact 0 only while each dp below is formed by the
//    same chain (same order, same rounded dO): both kernels keep it so.
// 2. attn_bwd_dkdv: one block of 128 threads per (range of 128*KPT keys,
//    head, element); KPT = 2 keys per thread at D <= 16, 1 at D = 32. Each
//    warp ballots KPT 32-key words of the mask, and a prefix over the words
//    packs the range's active keys into shared memory, in key order. The
//    packed keys need `need` warps; the block's 4 warps form 4/need
//    partitions (4, 2 or 1) of `need` warps, each over every (4/need)-th
//    query row, so a sparse range keeps its warps busy. Thread t of a
//    partition owns packed slots KPT*t .. KPT*t + KPT-1; a warp past the
//    count or the partitions skips the query loop (it still meets every
//    barrier), and partition 0 adds the others' dk and dv in partition
//    order. Masked keys of the range get zero rows; a range with no active
//    key writes only those and returns. The block
//    stages tiles of 128 query rows in shared memory (q, dO as 16-byte
//    vectors; L in base 2 and delta), once for all its keys. Per query a
//    thread forms s and dp for its KPT keys (2*KPT independent fmaf chains,
//    fed by broadcast reads of the q and dO rows), p = exp2(s - L2) with k
//    pre-scaled by log2(e)/sqrt(D) in registers, ds = p (dp - delta), then
//    dv += p dO and dk += ds q. An empty slot has k = v = 0 and p forced to
//    0, so it adds nothing and never makes a NaN.
// 3. attn_bwd_dq_partial: the forward's split over keys (attn_fwd_partial
//    in masked_attention_fwd.cu) without the running max, since L is known.
//    One block per (256 query rows, head, element, split), R rows per
//    thread (2 at D <= 16, 1 at D = 32) with q, dO, L, delta and the
//    accumulator in registers. Split s takes the 64-key windows
//    [s*T/S, (s+1)*T/S) of T; in each window two warps ballot and pack the
//    active keys (a window with none is skipped), whose K and V rows are
//    staged in shared memory and scored in chunks of 8: s and dp for the
//    chunk, then the exps and ds, then dq_s += ds k. The block writes its
//    split's fp32 partial dq_s [S, B, H, Q, D].
// 4. attn_bwd_dq_merge: one thread per (batch, head, row, channel) sums the
//    S partials in split order and writes dq = scale * sum in the input
//    dtype.
// The caller allocates delta and the partials (S*B*Q*C floats); the
// kernels allocate nothing.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s HBM): the function needs S, dP, dV, dK and dQ for every active
// key and query row, 2*D FLOP each per head: 10*Q*C FLOP per active key.
// This design does 14*Q*C (the dq pass forms S and dP again). At the train
// step's shape (B=16, Q=250, C=64, all 98,800 keys active) that is 0.236
// ms of fp32 operations against tens of microseconds of bytes: operations
// bound it, and masked keys cost neither. Both dtypes run the fp32
// arithmetic on the CUDA cores (the train path is fp32, where a tensor core
// would mean TF32). What this design leaves: keys are not compacted across
// blocks (a range whose keys need 3 warps idles its 4th), the tiles are
// loaded synchronously (no cp.async), and bf16 does not use the tensor
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDkdvThreads = 128;   // threads of an attn_bwd_dkdv block
constexpr int kQTile = 128;         // query rows per staged tile of attn_bwd_dkdv
constexpr int kRowsPerBlock = 256;  // query rows per attn_bwd_dq_partial block (the forward's)
constexpr int kKeys = 64;           // keys per window: two warps' ballots (the forward's)
constexpr int kChunk = 8;           // keys scored at once in attn_bwd_dq_partial
constexpr int kDeltaThreads = 256;
constexpr int kMergeThreads = 128;
constexpr double kLog2e = 1.4426950408889634;

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

// Elements of T per global-memory vector of a D-wide head row: 16 bytes,
// or the whole row where it is narrower. Always a power of two dividing D.
template <typename T, int D>
__host__ __device__ constexpr int vec_width() {
  return 16 / (int)sizeof(T) < D ? 16 / (int)sizeof(T) : D;
}

template <typename T, int W>
struct alignas(sizeof(T) * W) Packed {
  T x[W];
};

// W consecutive elements from global memory in one aligned vector load, widened to fp32.
template <typename T, int W>
__device__ __forceinline__ void load_global(const T* p, float* x) {
  const Packed<T, W> t = *reinterpret_cast<const Packed<T, W>*>(p);
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = to_float(t.x[i]);
}

template <typename T, int W>
__device__ __forceinline__ void store_global(T* p, const float* x) {
  Packed<T, W> t;
#pragma unroll
  for (int i = 0; i < W; ++i) t.x[i] = from_float<T>(x[i]);
  *reinterpret_cast<Packed<T, W>*>(p) = t;
}

// A D-wide row of fp32 values to global memory as vectors of T.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float* x) {
  constexpr int W = vec_width<T, D>();
#pragma unroll
  for (int d = 0; d < D; d += W) store_global<T, W>(p + d, x + d);
}

// W consecutive floats from (or to) shared memory in float4 or float2 vectors.
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x;
      x[i + 1] = t.y;
      x[i + 2] = t.z;
      x[i + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// delta[b, h, i] = sum_d dO[b, i, h*D + d] * O[b, i, h*D + d], one thread per (b, i, h).
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads) attn_bwd_delta(const T* __restrict__ out,
                                                               const T* __restrict__ dout,
                                                               float* __restrict__ delta, int B,
                                                               int Q, int H) {
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

// Launch bounds of one resident block per SM (here and in
// attn_bwd_dq_partial): without them ptxas may spill a few registers to
// keep more blocks resident.
template <typename T, int D, int KPT>
__global__ void __launch_bounds__(kDkdvThreads, 1) attn_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Q, int M, int H,
    float scale, float scale_log2) {
  constexpr int kRange = kDkdvThreads * KPT;  // keys per block
  constexpr int kWords = kRange / 32;         // ballot words per block, KPT per warp
  constexpr int W = vec_width<T, D>();        // elements per global vector
  constexpr int V = D / W;                    // global vectors per row (a power of two)
  constexpr int WS = D % 4 == 0 ? 4 : 2;      // floats per shared vector read
  // The staged q and dO rows; after the last tile, the partitions' partial
  // dk and dv (2 * KPT * D * 64 <= 2 * kQTile * D floats).
  __shared__ __align__(16) float qd_s[2][kQTile][D];
  float(*q_s)[D] = qd_s[0];
  float(*do_s)[D] = qd_s[1];
  float* red_s = &qd_s[0][0][0];
  __shared__ float2 ld_s[kQTile];  // (L * log2 e, delta) of each staged row
  __shared__ int idx_s[kRange];
  __shared__ unsigned ballot_s[kWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const int key0 = blockIdx.x * kRange;
  const float* mb = mask + (int64_t)b * M;
  const T* kb = k + (int64_t)b * M * C + (int64_t)h * D;
  const T* vb = v + (int64_t)b * M * C + (int64_t)h * D;
  T* dkb = dk + (int64_t)b * M * C + (int64_t)h * D;
  T* dvb = dv + (int64_t)b * M * C + (int64_t)h * D;

  // Warp w ballots the mask words w*KPT .. w*KPT + KPT-1 of the range.
  bool act[KPT];
  unsigned word[KPT];
#pragma unroll
  for (int g = 0; g < KPT; ++g) {
    const int key = key0 + (warp * KPT + g) * 32 + lane;
    act[g] = key < M && mb[key] > 0.f;
    word[g] = __ballot_sync(0xffffffffu, act[g]);
    if (lane == 0) ballot_s[warp * KPT + g] = word[g];
  }
  __syncthreads();
  int count = 0;
  int base[KPT];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
#pragma unroll
    for (int g = 0; g < KPT; ++g)
      if (w == warp * KPT + g) base[g] = count;
    count += __popc(ballot_s[w]);
  }
  const float zeros[D] = {};
#pragma unroll
  for (int g = 0; g < KPT; ++g) {
    const int key = key0 + (warp * KPT + g) * 32 + lane;
    if (act[g]) {  // pack the active keys to the front, in key order
      idx_s[base[g] + __popc(word[g] & ((1u << lane) - 1u))] = key;
    } else if (key < M) {  // a masked key: exact zero rows
      store_row<T, D>(dkb + (int64_t)key * C, zeros);
      store_row<T, D>(dvb + (int64_t)key * C, zeros);
    }
  }
  if (count == 0) return;  // uniform: no active key in this range
  __syncthreads();

  // Partitions of `need` warps, each over every parts-th query row.
  const int need = (count + 32 * KPT - 1) / (32 * KPT);
  const int parts = (kDkdvThreads / 32) / need;  // 4, 2, 1 or 1
  const int part = warp / need;
  const int lt = tid - part * need * 32;  // thread index within its partition
  float kr[KPT][D];  // k * log2(e) / sqrt(D): scores in base 2
  float vr[KPT][D];
  float dka[KPT][D];
  float dva[KPT][D];
  bool live[KPT];
  int own[KPT];
#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    const int slot = lt * KPT + s;
    live[s] = part < parts && slot < count;
    own[s] = live[s] ? idx_s[slot] : 0;
#pragma unroll
    for (int d = 0; d < D; d += W) {
      if (live[s]) {
        load_global<T, W>(kb + (int64_t)own[s] * C + d, &kr[s][d]);
        load_global<T, W>(vb + (int64_t)own[s] * C + d, &vr[s][d]);
      } else {  // an empty slot: zero k and v, its p forced to 0 below
#pragma unroll
        for (int x = 0; x < W; ++x) kr[s][d + x] = vr[s][d + x] = 0.f;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[s][d] *= scale_log2;
      dka[s][d] = 0.f;
      dva[s][d] = 0.f;
    }
  }
  const bool busy = live[0];  // false for a whole warp past the count or the partitions

  const T* qb = q + (int64_t)b * Q * C + (int64_t)h * D;
  const T* dob = dout + (int64_t)b * Q * C + (int64_t)h * D;
  const float* lb = lse + ((int64_t)b * H + h) * Q;
  const float* db = delta + ((int64_t)b * H + h) * Q;
  const float log2e = (float)kLog2e;

  for (int i0 = 0; i0 < Q; i0 += kQTile) {
    const int n = min(kQTile, Q - i0);
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < n * V; e += kDkdvThreads) {
      const int r = e / V;  // V is a power of two: a shift
      const int c = (e % V) * W;
      const int64_t off = (int64_t)(i0 + r) * C + c;
      float x[W];
      load_global<T, W>(qb + off, x);
      store_vec<W>(&q_s[r][c], x);
      load_global<T, W>(dob + off, x);
      store_vec<W>(&do_s[r][c], x);
    }
    for (int r = tid; r < n; r += kDkdvThreads) ld_s[r] = make_float2(lb[i0 + r] * log2e, db[i0 + r]);
    __syncthreads();
    if (!busy) continue;
    for (int i = part; i < n; i += parts) {
      float qx[D], dx[D];
#pragma unroll
      for (int d = 0; d < D; d += WS) {
        load_vec<WS>(&q_s[i][d], &qx[d]);
        load_vec<WS>(&do_s[i][d], &dx[d]);
      }
      float s[KPT], dp[KPT];
#pragma unroll
      for (int t = 0; t < KPT; ++t) s[t] = dp[t] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int t = 0; t < KPT; ++t) {
          s[t] = fmaf(qx[d], kr[t][d], s[t]);
          dp[t] = fmaf(dx[d], vr[t][d], dp[t]);  // delta's chain: d ascending from 0
        }
      }
      const float2 ld = ld_s[i];
#pragma unroll
      for (int t = 0; t < KPT; ++t) {
        const float p = live[t] ? exp2f(s[t] - ld.x) : 0.f;
        const float ds = p * (dp[t] - ld.y);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[t][d] = fmaf(p, dx[d], dva[t][d]);
          dka[t][d] = fmaf(ds, qx[d], dka[t][d]);
        }
      }
    }
  }

  // red_s[((s * 2 + dk/dv) * D + d) * 64 + lt]: neighbouring threads on
  // neighbouring words. parts > 1 means need <= 2, so lt < 64.
  for (int src = 1; src < parts; ++src) {
    __syncthreads();  // the tiles, or the previous partition's sums, are read
    if (part == src) {
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          red_s[((s * 2) * D + d) * 64 + lt] = dka[s][d];
          red_s[((s * 2 + 1) * D + d) * 64 + lt] = dva[s][d];
        }
      }
    }
    __syncthreads();
    if (part == 0) {
#pragma unroll
      for (int s = 0; s < KPT; ++s) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dka[s][d] += red_s[((s * 2) * D + d) * 64 + lt];
          dva[s][d] += red_s[((s * 2 + 1) * D + d) * 64 + lt];
        }
      }
    }
  }

  if (part != 0) return;
#pragma unroll
  for (int s = 0; s < KPT; ++s) {
    if (!live[s]) continue;
#pragma unroll
    for (int d = 0; d < D; ++d) dka[s][d] *= scale;
    store_row<T, D>(dkb + (int64_t)own[s] * C, dka[s]);
    store_row<T, D>(dvb + (int64_t)own[s] * C, dva[s]);
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kRowsPerBlock / R, 1) attn_bwd_dq_partial(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, float* __restrict__ part, int B, int Q, int M, int H, int S,
    float scale_log2) {
  constexpr int kThreads = kRowsPerBlock / R;
  constexpr int W = vec_width<T, D>();
  constexpr int V = D / W;
  constexpr int WS = D % 4 == 0 ? 4 : 2;
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
  const float log2e = (float)kLog2e;

  float qr[R][D];  // q * log2(e) / sqrt(D): scores in base 2
  float dor[R][D];
  float acc[R][D];
  float l2[R];  // L * log2(e); +inf past Q, so p = 0 there
  float dl[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = blockIdx.x * kRowsPerBlock + i * kThreads + tid;
    const bool rlive = row < Q;
    const int64_t q_off = ((int64_t)b * Q + row) * C + (int64_t)h * D;
#pragma unroll
    for (int d = 0; d < D; d += W) {
      if (rlive) {
        load_global<T, W>(q + q_off + d, &qr[i][d]);
        load_global<T, W>(dout + q_off + d, &dor[i][d]);
      } else {
#pragma unroll
        for (int x = 0; x < W; ++x) qr[i][d + x] = dor[i][d + x] = 0.f;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[i][d] *= scale_log2;
      acc[i][d] = 0.f;
    }
    const int64_t l_off = ((int64_t)b * H + h) * Q + row;
    // A fully masked element has L = +inf and no active window, so it never
    // reaches the scoring below.
    l2[i] = rlive ? lse[l_off] * log2e : INFINITY;
    dl[i] = rlive ? delta[l_off] : 0.f;
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
    // Rows past `count` up to the chunk edge are zeros, and their p is
    // forced to 0 below.
    const int padded = (count + kChunk - 1) / kChunk * kChunk;
    for (int e = tid; e < padded * V; e += kThreads) {
      const int r = e / V;
      const int c = (e % V) * W;
      float kx[W], vx[W];
      if (r < count) {
        const int64_t off = (int64_t)idx_s[r] * C + c;
        load_global<T, W>(kb + off, kx);
        load_global<T, W>(vb + off, vx);
      } else {
#pragma unroll
        for (int x = 0; x < W; ++x) kx[x] = vx[x] = 0.f;
      }
      store_vec<W>(&k_s[r][c], kx);
      store_vec<W>(&v_s[r][c], vx);
    }
    __syncthreads();

    for (int j0 = 0; j0 < count; j0 += kChunk) {
      float s[R][kChunk], dp[R][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int i = 0; i < R; ++i) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += WS) {
          float kx[WS], vx[WS];
          load_vec<WS>(&k_s[j0 + jj][d], kx);
          load_vec<WS>(&v_s[j0 + jj][d], vx);
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int x = 0; x < WS; ++x) {
              s[i][jj] = fmaf(qr[i][d + x], kx[x], s[i][jj]);
              dp[i][jj] = fmaf(dor[i][d + x], vx[x], dp[i][jj]);  // delta's chain
            }
          }
        }
      }
      const int live_keys = count - j0;  // >= 1; chunk slots from here on are padding
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float p = jj < live_keys ? exp2f(s[i][jj] - l2[i]) : 0.f;
          s[i][jj] = p * (dp[i][jj] - dl[i]);  // ds
        }
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int d = 0; d < D; d += WS) {
          float kx[WS];
          load_vec<WS>(&k_s[j0 + jj][d], kx);
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int x = 0; x < WS; ++x) acc[i][d + x] = fmaf(s[i][jj], kx[x], acc[i][d + x]);
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
#pragma unroll
    for (int d = 0; d < D; d += WS) store_vec<WS>(part + idx * D + d, &acc[i][d]);
  }
}

// One thread per (batch, head, row, channel) sums the S partials in split
// order; neighbouring threads read neighbouring channels, so every load is
// coalesced.
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads) attn_bwd_dq_merge(const float* __restrict__ part,
                                                                  T* __restrict__ dq, int B, int Q,
                                                                  int H, int S, float scale) {
  const int64_t rows = (int64_t)B * H * Q;
  const int64_t e = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= rows * D) return;
  const int d = (int)(e % D);
  const int64_t idx = e / D;  // (b, h, row)
  const int row = (int)(idx % Q);
  const int64_t bh = idx / Q;
  const int h = (int)(bh % H);
  const int64_t b = bh / H;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[s * rows * D + e];  // in split order
  dq[(b * Q + row) * (int64_t)(H * D) + (int64_t)h * D + d] = from_float<T>(acc * scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* out,
           const void* lse, const void* dout, void* delta, void* work, void* dq, void* dk,
           void* dv, int B, int Q, int M, int H, int S, cudaStream_t stream) {
  constexpr int KPT = D <= 16 ? 2 : 1;  // keys per thread of attn_bwd_dkdv
  constexpr int R = D <= 16 ? 2 : 1;    // rows per thread of attn_bwd_dq_partial
  const float scale = 1.0f / sqrtf((float)D);
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  const int64_t rows = (int64_t)B * Q * H;
  attn_bwd_delta<T, D><<<(unsigned)((rows + kDeltaThreads - 1) / kDeltaThreads), kDeltaThreads, 0,
                         stream>>>(static_cast<const T*>(out), static_cast<const T*>(dout),
                                   static_cast<float*>(delta), B, Q, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (M > 0) {
    constexpr int kRange = kDkdvThreads * KPT;
    const dim3 kgrid((M + kRange - 1) / kRange, H, B);
    attn_bwd_dkdv<T, D, KPT><<<kgrid, kDkdvThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const T*>(dout), static_cast<T*>(dk),
        static_cast<T*>(dv), Q, M, H, scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  float* part = static_cast<float*>(work);
  const dim3 qgrid((Q + kRowsPerBlock - 1) / kRowsPerBlock, H, B * S);
  attn_bwd_dq_partial<T, D, R><<<qgrid, kRowsPerBlock / R, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout), part, B, Q, M, H, S,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t merge_blocks = (rows * D + kMergeThreads - 1) / kMergeThreads;
  attn_bwd_dq_merge<T, D><<<(unsigned)merge_blocks, kMergeThreads, 0, stream>>>(
      part, static_cast<T*>(dq), B, Q, H, S, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* mask, const void* out,
             const void* lse, const void* dout, void* delta, void* work, void* dq, void* dk,
             void* dv, int B, int Q, int M, int H, int D, int S, cudaStream_t s) {
  switch (D) {
    case 2:
      return launch<T, 2>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, S, s);
    case 4:
      return launch<T, 4>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, S, s);
    case 8:
      return launch<T, 8>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, S, s);
    case 16:
      return launch<T, 16>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, S, s);
    case 32:
      return launch<T, 32>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, S, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `delta` is fp32 scratch of B*H*Q
// floats, `work` S*B*Q*C floats of dq partials, S the number of splits over
// keys (1 <= S, B*S <= 65535). Returns the first non-zero
// cudaGetLastError() of the four launches (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernels do not take. Launches on
// `stream` and does not synchronise.
extern "C" int masked_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* mask, const void* out, const void* lse,
                                    const void* dout, void* delta, void* work, void* dq, void* dk,
                                    void* dv, int B, int Q, int M, int C, int H, int S, int dtype,
                                    void* stream) {
  if (B <= 0 || B > 65535 || Q <= 0 || M < 0 || H <= 0 || H > 65535 || C % H != 0 || S <= 0 ||
      (int64_t)B * S > 65535)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q, M, H, D,
                           S, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, mask, out, lse, dout, delta, work, dq, dk, dv, B, Q,
                                   M, H, D, S, s);
  return (int)cudaErrorInvalidValue;
}
