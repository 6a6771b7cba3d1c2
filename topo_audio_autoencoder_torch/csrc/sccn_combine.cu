// Fused SCCN message combine for Hopper (sm_90a): forward, backward, and the
// diagnostic variants of the forward.
//
// Replaces the TPU kernels
//   topo_audio_autoencoder_tpu/ops/sccn_combine.py:90  _fwd_kernel (launched by _fwd_call :253)
//   topo_audio_autoencoder_tpu/ops/sccn_combine.py:128 _bwd_kernel (launched by _bwd_call :279)
//   benchmarks/kernel_diag.py:125 _packed_kernel (packed_call :272)
//   benchmarks/kernel_diag.py:166 _packed_bwd_kernel (packed_bwd_call :301)
//   benchmarks/kernel_diag.py:73, :80, :92 _copy_kernel, _matmul_kernel,
//     _nogelu_kernel (_simple_call :370)
// Same function, per row p of P = B*S rows and each of M in {1, 2, 3} messages:
//   msg_m = car_m[p] V_m + x[p]          (V_m = W_m * scale_m, folded by the caller)
//   h_m   = gelu_tanh(msg_m W1 + b1)
//   s_m   = h_m . w2
//   attn  = softmax_m(s)                 (fp32; sigmoid(s0 - s1) in the packed variant)
//   y[p]  = sum_m attn_m msg_m
// The backward recomputes the forward from the same inputs and writes dcar_m
// and dx per row (dx = sum_m dmsg_m: the residual enters every message) and
// dV [M, C, C], dW1, db1, dw2 summed over all rows. C = 64, the flagship
// width, is the only width built.
//
// Variants, one template each, sharing the device code below:
//   kFull    rows 6 and 7.
//   kPacked  rows 8 and 9: M = 2 with both carriers interleaved in one
//            [P, 2C] buffer (car_m at column offset m*C, row stride 2C), the
//            softmax over two messages as sigmoid(s0 - s1), and the packed
//            kernels' cast points (each weighted message, and each dmsg_m in
//            dx, rounded to the input type before the sum). The TPU's block
//            diagonal weights and 0/1 tile/fold matrices are a lane layout of
//            the TPU; this kernel reads the same unpacked V, W1, b1, w2.
//   kNoGelu  row 10: kFull with the identity in place of gelu.
//   kMatmul  row 10: y = sum_m (car_m V_m + x), no attention MLP.
//   kCopy    row 10: y = x + sum_m car_m, no arithmetic but the adds.
//
// Cast points are the TPU kernels', not the plain torch version's (which
// rounds every op to the input type): every product accumulates in fp32,
// msg is rounded to the input type only as the operand of the W1 product,
// dpre and dmsg only as operands of the backward products, and each output
// once. The kernel replaces the TPU kernel, so it computes its function; a
// tensor-core version (wgmma takes bf16 operands at exactly these points)
// would not move the results. In fp32 the rounding is the identity.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM; 67 TFLOP/s fp32 outside the
// tensor cores; 989 TFLOP/s bf16 in them): the forward must move (M + 2) P C
// elements and do about 4C^2 + 16C operations per row and message; at C = 64
// in fp32 that is 1 KB against 35 kFLOP per row at M = 2, so the operations
// bound it (bytes in bf16, where the products could run on tensor cores).
// The backward does three times the forward's operations and moves
// (2M + 3) P C elements.
//
// Design. Both dtypes compute in fp32 on the CUDA cores. Blocks of 256
// threads each own one contiguous range of rows: the P rows in units of 32,
// split so that ranges differ by at most one unit (row_range). A range walks
// 64-row tiles and ends, where it has one, with a 32-row half tile, which
// runs half the per-thread rows (a template of its own), so no block waits a
// whole tile for half a tile of work. Each block stages V_m and W1 in shared
// memory as fp32 once. In a tile, thread (tx, ty) owns rows ty + 16i (i < 4,
// or < 2 in a half tile) and channels 4tx..4tx+3 of every [rows, 64] product,
// whose 16 threads of a row sum its score by shuffles; in a product over rows
// (dW1, dV) it owns the [4ty.., 4tx..] block of the [64, 64] result.
// Products read shared memory as float4: 4 consecutive k of an activation
// row, 4 consecutive channels of a weight row, and (for a b^T with b a
// weight) 4 consecutive k of 4 weight rows. Per 4 k a thread's 4 x 4 tile
// issues 8 LDS.128 for 64 FFMA; a warp's loads there are 4 of one wavefront
// (two rows, broadcast over 16 lanes) and 4 of two (16 chunks), 12
// wavefronts for 64 warp-FFMA, and a product over rows 3 for 16. Tiles have
// no padding: float4 chunk q of row r sits at chunk q ^ (r & 7) in an
// activation tile and q ^ ((r >> 2) & 7) in a weight tile, which keeps every
// one of these reads and the stores free of bank conflicts. Every k-sum runs
// in ascending k from 0.f. Global rows move as 16-byte (fp32) or 8-byte
// (bf16) vectors.
// The forward stages one carrier tile and one rounded-msg tile at a time,
// two barriers a message, and fits two blocks on an SM (one at M = 3, where
// two would spill). The backward keeps every carrier tile and every rounded
// msg tile of a tile in shared memory (each carrier staged once, for car V_m
// and car^T dmsg), computes one tanhf per element of pre in its recompute,
// from which gelu and gelu' come in the same formulas as the forward's, and
// forms every message's dpre right after the softmax; its loop over messages
// runs two barriers a message (separate dpre and dmsg tiles), 2M + 3 a tile.
// It runs one block per SM (registers), and at M = 3 only 32-row tiles,
// whose per-thread state fits the 255 registers. It keeps dV in shared
// memory and dW1 in registers, each element owned by one thread, and db1/dw2
// as per-thread partials reduced in a fixed order at the block's end; each
// block writes one row of fp32 partials, and reduce_partials sums the rows
// in block order: one writer per output, no atomics, the same result on
// every run. The TPU kernel's accumulation over its sequential grid is this
// loop inside a block plus the second pass.
// What this design leaves: scalar FMAs instead of wgmma; one block per SM
// in the backward, whose eight warps all wait out each tile's global loads;
// a 4 x 4 micro-tile, which reads as many shared floats per FMA as before
// if a 16-byte shared load costs four wavefronts however many lanes share
// an address.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kC = 64;                   // channels: the only width built
constexpr int kRows = 64;                // rows of a tile
constexpr int kUnit = 32;                // rows of a unit of the row split, and of a half tile
constexpr int kThreads = 256;            // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kChunks = kC / 4;          // float4 chunks in a staged row
constexpr int kTileElems = kRows * kC;   // one staged [64, 64] tile (activations or weights)
static_assert(kRows == kC, "a staged tile holds rows or a weight matrix alike");
// Steps of a product's k loop (4 k each) and of a row loop unrolled: more
// spills the backward at M = 2 and ran no faster on an H100.
constexpr int kUnrollK = 2;
constexpr int kUnrollR = 4;

enum Mode : int { kFull = 0, kPacked = 1, kNoGelu = 2, kMatmul = 3, kCopy = 4 };

constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;

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

// x rounded to T and back: the cast of a product's operand to the input type.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Four consecutive elements of a row in global memory, as fp32.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four consecutive elements of a row, each rounded once to T.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 lds4(const float* s) { return *reinterpret_cast<const float4*>(s); }
__device__ __forceinline__ void sts4(float* s, float4 v) { *reinterpret_cast<float4*>(s) = v; }

// Component k of a float4, for k known at compile time.
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Where float4 chunk q (channels 4q..4q+3) of row r lies in a staged tile.
__device__ __forceinline__ int act_at(int r, int q) { return r * kC + ((q ^ (r & 7)) << 2); }
__device__ __forceinline__ int wt_at(int r, int q) { return r * kC + ((q ^ ((r >> 2) & 7)) << 2); }

__device__ __forceinline__ float gelu_arg(float x) { return kSqrt2OverPi * (x + kGeluC * x * x * x); }

// gelu and its derivative at x from t = tanh(gelu_arg(x)).
__device__ __forceinline__ float gelu_of(float x, float t) { return 0.5f * x * (1.0f + t); }

__device__ __forceinline__ float gelu_grad_of(float x, float t) {
  const float du = kSqrt2OverPi * (1.0f + 3.0f * kGeluC * x * x);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// Sum over the 16 lanes of a half-warp (the 16 threads that share a row).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Carriers {
  const T* ptr[3];  // car_m for m < M
  int64_t stride;   // elements between consecutive rows: C, or 2C packed
};

template <typename T>
struct CarrierGrads {
  T* ptr[3];
  int64_t stride;
};

// This block's rows [start, end): the ceil(P / 32) units split among the
// grid in contiguous ranges whose sizes differ by at most one unit.
__device__ __forceinline__ void row_range(int64_t P, int64_t& start, int64_t& end) {
  const int64_t units = (P + kUnit - 1) / kUnit;
  start = (int64_t)blockIdx.x * units / gridDim.x * kUnit;
  const int64_t stop = ((int64_t)blockIdx.x + 1) * units / gridDim.x * kUnit;
  end = stop < P ? stop : P;
}

// Rows [row0, row0 + 16 NI) of a [P, *] tensor into a staged fp32 tile;
// rows from `end` on are zero.
template <typename T, int NI>
__device__ __forceinline__ void stage_rows(float* s, const T* g, int64_t stride, int64_t row0,
                                           int64_t end) {
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int e = threadIdx.x + kThreads * n;
    const int r = e / kChunks;
    const int q = e % kChunks;
    const int64_t row = row0 + r;
    sts4(s + act_at(r, q), row < end ? load4(g + row * stride + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

template <typename T>
__device__ __forceinline__ void stage_weights(float* s, const T* __restrict__ g) {
  for (int e = threadIdx.x; e < kC * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int q = e % kChunks;
    sts4(s + wt_at(r, q), load4(g + r * kC + 4 * q));
  }
}

// A thread's rows ty + 16i, channels 4tx..4tx+3, of a [P, *] tensor; rows
// from `end` on are zero.
template <typename T, int NI>
__device__ __forceinline__ void load_rows(float r[][4], const T* g, int64_t stride, int64_t row0,
                                          int64_t end, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    const float4 v = row < end ? load4(g + row * stride + 4 * tx) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[i][0] = v.x;
    r[i][1] = v.y;
    r[i][2] = v.z;
    r[i][3] = v.w;
  }
}

template <typename T, int NI>
__device__ __forceinline__ void store_rows(T* g, int64_t stride, const float r[][4], int64_t row0,
                                           int64_t end, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row < end) store4(g + row * stride + 4 * tx, make_float4(r[i][0], r[i][1], r[i][2], r[i][3]));
  }
}

template <int NI>
__device__ __forceinline__ void zero(float a[][4]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// acc[i][j] += sum_k a[ty + 16i][k] * b[k][4tx + j]    (a b: a activations, b a weight)
template <int NI>
__device__ __forceinline__ void mm_nn(float acc[][4], const float* a, const float* b, int tx, int ty) {
#pragma unroll kUnrollK
  for (int q = 0; q < kChunks; ++q) {
    float4 av[NI], bv[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) av[i] = lds4(a + act_at(ty + 16 * i, q));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = lds4(b + wt_at(4 * q + kk, tx));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float ak = at(av[i], kk);
        acc[i][0] = fmaf(ak, bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(ak, bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(ak, bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(ak, bv[kk].w, acc[i][3]);
      }
  }
}

// acc[i][j] += sum_k a[ty + 16i][k] * b[4tx + j][k]    (a b^T: a activations, b a weight)
template <int NI>
__device__ __forceinline__ void mm_nt(float acc[][4], const float* a, const float* b, int tx, int ty) {
#pragma unroll kUnrollK
  for (int q = 0; q < kChunks; ++q) {
    float4 av[NI], bv[4];
#pragma unroll
    for (int i = 0; i < NI; ++i) av[i] = lds4(a + act_at(ty + 16 * i, q));
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = lds4(b + wt_at(4 * tx + j, q));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float ak = at(av[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ak, at(bv[j], kk), acc[i][j]);
      }
  }
}

// acc[i][j] += sum_{r < R} a[r][4ty + i] * b[r][4tx + j]    (a^T b over a tile's R rows)
template <int R>
__device__ __forceinline__ void mm_tn(float acc[4][4], const float* a, const float* b, int tx, int ty) {
#pragma unroll kUnrollR
  for (int r = 0; r < R; ++r) {
    const float4 av = lds4(a + act_at(r, ty));
    const float4 bv = lds4(b + act_at(r, tx));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai = at(av, i);
      acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
      acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
      acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
      acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
    }
  }
}

// Writes a thread's rows into a staged tile, each value rounded to T.
template <typename T, int NI>
__device__ __forceinline__ void put_rounded(float* s, const float r[][4], int tx, int ty) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
    sts4(s + act_at(ty + 16 * i, tx), make_float4(round_to<T>(r[i][0]), round_to<T>(r[i][1]),
                                                  round_to<T>(r[i][2]), round_to<T>(r[i][3])));
}

// The attention weights of each of a thread's rows from the scores, in the
// TPU kernels' order: max, exp(s - max), their sum, exp / sum; or, packed,
// a0 = sigmoid(s0 - s1), a1 = 1 - a0.
template <int M, int MODE, int NI>
__device__ __forceinline__ void attention_weights(const float s[M][NI], float a[M][NI]) {
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if constexpr (MODE == kPacked) {
      a[0][i] = 1.0f / (1.0f + expf(-(s[0][i] - s[1][i])));
      a[1][i] = 1.0f - a[0][i];
    } else {
      float smax = s[0][i];
#pragma unroll
      for (int m = 1; m < M; ++m) smax = fmaxf(smax, s[m][i]);
      float e[M];
      float denom = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        e[m] = expf(s[m][i] - smax);
        denom = m == 0 ? e[m] : denom + e[m];
      }
#pragma unroll
      for (int m = 0; m < M; ++m) a[m][i] = e[m] / denom;
    }
  }
}

// The forward's shared memory, in floats: V_m (kMix), W1 (kScore), one
// carrier tile (kMix), the rounded-msg tile, b1 and w2 (kScore).
constexpr size_t fwd_smem_floats(int M, int mode) {
  return mode == kCopy     ? 0
         : mode == kMatmul ? (size_t)(M + 1) * kTileElems
                           : (size_t)(M + 3) * kTileElems + 2 * kC;
}

// Blocks per SM the forward is compiled for. Its shared memory allows two;
// at M = 3 two would cap a thread at 128 registers, and the messages kept
// for the weighted sum would spill: one block, 167 registers, as fast.
template <int M>
constexpr int kFwdMinBlocks = M == 3 ? 1 : 2;

struct FwdSmem {
  float* v;
  float* w1;
  float* car;
  float* msg;
  const float* b1;
  const float* w2;
};

// One tile of the forward: rows [row0, row0 + 16 NI), those from `end` on
// masked. Two barriers a message: the carrier tile is staged, then msg.
template <typename T, int M, int MODE, int NI>
__device__ __forceinline__ void fwd_tile(const FwdSmem& s, const Carriers<T>& car, const T* __restrict__ x,
                                         T* __restrict__ y, int64_t row0, int64_t end, int tx, int ty) {
  float xr[NI][4];
  load_rows<T, NI>(xr, x, kC, row0, end, tx, ty);
  if constexpr (MODE == kCopy) {
    // y = x + car_0 + ... + car_{M-1}, in that order.
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float cr[NI][4];
      load_rows<T, NI>(cr, car.ptr[m], car.stride, row0, end, tx, ty);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[i][j] += cr[i][j];
    }
    store_rows<T, NI>(y, kC, xr, row0, end, tx, ty);
  } else if constexpr (MODE == kMatmul) {
    // y = sum_m (car_m V_m + x), accumulated from 0 in message order.
    float out[NI][4];
    zero<NI>(out);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      stage_rows<T, NI>(s.car, car.ptr[m], car.stride, row0, end);
      __syncthreads();
      float acc[NI][4];
      zero<NI>(acc);
      mm_nn<NI>(acc, s.car, s.v + m * kTileElems, tx, ty);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = out[i][j] + acc[i][j] + xr[i][j];
      __syncthreads();  // every thread is done with the carrier tile
    }
    store_rows<T, NI>(y, kC, out, row0, end, tx, ty);
  } else {
    const float4 b1v = lds4(s.b1 + 4 * tx);
    const float4 w2v = lds4(s.w2 + 4 * tx);
    float msg[M][NI][4];
    float score[M][NI];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      // The previous message's last barrier ended every read of the carrier tile.
      stage_rows<T, NI>(s.car, car.ptr[m], car.stride, row0, end);
      __syncthreads();  // the carrier staged; every thread is done reading msg_s
      float acc[NI][4];
      zero<NI>(acc);
      mm_nn<NI>(acc, s.car, s.v + m * kTileElems, tx, ty);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) msg[m][i][j] = acc[i][j] + xr[i][j];
      put_rounded<T, NI>(s.msg, msg[m], tx, ty);  // msg in the input type, as W1's operand
      __syncthreads();  // msg staged; every thread is done reading the carrier tile
      zero<NI>(acc);
      mm_nn<NI>(acc, s.msg, s.w1, tx, ty);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pre = acc[i][j] + at(b1v, j);
          const float h = MODE == kNoGelu ? pre : gelu_of(pre, tanhf(gelu_arg(pre)));
          part += h * at(w2v, j);
        }
        score[m][i] = sum16(part);
      }
    }
    float attn[M][NI];
    attention_weights<M, MODE, NI>(score, attn);
    float out[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (MODE == kPacked) {
          // Each weighted message in the input type, summed in fp32.
          out[i][j] = round_to<T>(msg[0][i][j] * attn[0][i]) + round_to<T>(msg[1][i][j] * attn[1][i]);
        } else {
          float acc = msg[0][i][j] * attn[0][i];
#pragma unroll
          for (int m = 1; m < M; ++m) acc += msg[m][i][j] * attn[m][i];
          out[i][j] = acc;
        }
      }
    store_rows<T, NI>(y, kC, out, row0, end, tx, ty);
  }
}

template <typename T, int M, int MODE>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks<M>) combine_fwd_kernel(Carriers<T> car,
                                                                              const T* __restrict__ x,
                                                                              const T* __restrict__ v,
                                                                              const T* __restrict__ w1,
                                                                              const T* __restrict__ b1,
                                                                              const T* __restrict__ w2,
                                                                              T* __restrict__ y, int64_t P) {
  constexpr bool kMix = MODE != kCopy;
  constexpr bool kScore = MODE == kFull || MODE == kPacked || MODE == kNoGelu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  FwdSmem s;
  s.v = smem;                                    // [M] weight tiles
  s.w1 = s.v + (kMix ? M * kTileElems : 0);      // weight tile
  s.car = s.w1 + (kScore ? kTileElems : 0);      // activation tile
  s.msg = s.car + (kMix ? kTileElems : 0);       // activation tile
  float* b1_s = s.msg + (kScore ? kTileElems : 0);
  float* w2_s = b1_s + kC;
  s.b1 = b1_s;
  s.w2 = w2_s;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  if constexpr (kMix) {
    for (int m = 0; m < M; ++m) stage_weights(s.v + m * kTileElems, v + m * kC * kC);
  }
  if constexpr (kScore) {
    stage_weights(s.w1, w1);
    for (int c = tid; c < kC; c += kThreads) {
      b1_s[c] = to_float(b1[c]);
      w2_s[c] = to_float(w2[c]);
    }
  }
  if constexpr (kMix) __syncthreads();  // the weights staged

  int64_t start, end;
  row_range(P, start, end);
  int64_t row0 = start;
  for (; row0 + kRows <= end; row0 += kRows) fwd_tile<T, M, MODE, 4>(s, car, x, y, row0, end, tx, ty);
  if (row0 < end) {
    if (end - row0 > kUnit) {
      fwd_tile<T, M, MODE, 4>(s, car, x, y, row0, end, tx, ty);
    } else {
      fwd_tile<T, M, MODE, 2>(s, car, x, y, row0, end, tx, ty);
    }
  }
}

// At M = 3 the backward walks 32-row tiles only: in a 64-row tile, pre and
// tanh of three messages (96 floats a thread) leave too few of the 255
// registers, and the kernel spilled 1.5 KB.
template <int M>
constexpr bool kBwdHalfTiles = M == 3;

// Floats of one of the backward's activation tiles.
__host__ __device__ constexpr int bwd_act_elems(int M) { return M == 3 ? kUnit * kC : kTileElems; }

// The backward's shared memory, in floats: V_m, W1 and the M dV
// accumulators as [64, 64] tiles; the M carrier tiles, the M rounded-msg
// tiles, the dpre tile and the dmsg tile as activation tiles; b1 and w2.
// The [2][16][kC] db1/dw2 partials of the block's end reuse the carrier
// tiles.
constexpr size_t bwd_smem_floats(int M) {
  return (size_t)(2 * M + 1) * kTileElems + (size_t)(2 * M + 2) * bwd_act_elems(M) + 2 * kC;
}

// One block's row of fp32 partials: dV [M, C, C], dW1 [C, C], db1 [C], dw2 [C].
__host__ __device__ constexpr int wgrad_elems(int M) { return M * kC * kC + kC * kC + 2 * kC; }

struct BwdSmem {
  float* v;
  float* w1;
  float* car;
  float* msg;
  float* dpre;
  float* dmsg;
  float* dv;
  const float* b1;
  const float* w2;
};

// One tile of the backward: rows [row0, row0 + 16 NI), those from `end` on
// masked (they add exact zeros to every sum). Accumulates dW1 (owned
// elements [4ty + i][4tx + j]), db1 and dw2 (per-thread partials of
// channels 4tx + j) in registers and dV in shared memory.
template <typename T, int M, int MODE, int NI>
__device__ __forceinline__ void bwd_tile(const BwdSmem& s, const Carriers<T>& car, const T* __restrict__ x,
                                         const T* __restrict__ dy, const CarrierGrads<T>& dcar,
                                         T* __restrict__ dx, int64_t row0, int64_t end, int tx, int ty,
                                         float dw1r[4][4], float db1p[4], float dw2p[4]) {
  constexpr int R = 16 * NI;
  constexpr int kAct = bwd_act_elems(M);
  static_assert(R * kC <= kAct, "a tile's rows fit its activation tiles");
  __syncthreads();  // every thread is done with the previous tile's shared tiles
#pragma unroll
  for (int m = 0; m < M; ++m) stage_rows<T, NI>(s.car + m * kAct, car.ptr[m], car.stride, row0, end);

  // --- recompute the forward; dattn_m = dy . msg_m with the fp32 msg ---
  float dattn[M][NI];
  {
    float xr[NI][4], dyr[NI][4];
    load_rows<T, NI>(xr, x, kC, row0, end, tx, ty);
    load_rows<T, NI>(dyr, dy, kC, row0, end, tx, ty);
    __syncthreads();  // the carriers staged
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float acc[NI][4];
      zero<NI>(acc);
      mm_nn<NI>(acc, s.car + m * kAct, s.v + m * kTileElems, tx, ty);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += xr[i][j];  // msg_m
          part += dyr[i][j] * acc[i][j];
        }
        dattn[m][i] = sum16(part);
      }
      put_rounded<T, NI>(s.msg + m * kAct, acc, tx, ty);
    }
  }
  __syncthreads();  // every msg tile staged
  const float4 b1v = lds4(s.b1 + 4 * tx);
  const float4 w2v = lds4(s.w2 + 4 * tx);
  // pre = msg W1 + b1 and t = tanh(gelu_arg(pre)), the one tanhf of each element
  float pre[M][NI][4], th[M][NI][4];
  float score[M][NI];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    zero<NI>(pre[m]);
    mm_nn<NI>(pre[m], s.msg + m * kAct, s.w1, tx, ty);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pre[m][i][j] += at(b1v, j);
        th[m][i][j] = tanhf(gelu_arg(pre[m][i][j]));
        part += gelu_of(pre[m][i][j], th[m][i][j]) * at(w2v, j);
      }
      score[m][i] = sum16(part);
    }
  }
  float attn[M][NI];
  attention_weights<M, MODE, NI>(score, attn);

  // ds_m = attn_m (dattn_m - sum_k attn_k dattn_k); packed: +-a0 a1 (dattn_0 - dattn_1)
  float ds[M][NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if constexpr (MODE == kPacked) {
      const float a0 = attn[0][i];
      const float dd = (dattn[0][i] - dattn[1][i]) * a0 * (1.0f - a0);
      ds[0][i] = dd;
      ds[1][i] = -dd;
    } else {
      float inner = attn[0][i] * dattn[0][i];
#pragma unroll
      for (int m = 1; m < M; ++m) inner += attn[m][i] * dattn[m][i];
#pragma unroll
      for (int m = 0; m < M; ++m) ds[m][i] = attn[m][i] * (dattn[m][i] - inner);
    }
  }

  // dpre_m = ds_m w2 gelu'(pre_m) for every message, with db1 and dw2
  float dpre[M][NI][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = pre[m][i][j];
        const float t = th[m][i][j];
        dpre[m][i][j] = ds[m][i] * at(w2v, j) * gelu_grad_of(p, t);
        db1p[j] += dpre[m][i][j];
        dw2p[j] += gelu_of(p, t) * ds[m][i];
      }

  // --- backward, message by message ---
  float dxr[NI][4];
  zero<NI>(dxr);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    // The previous message's barrier ended every read of dpre of before.
    put_rounded<T, NI>(s.dpre, dpre[m], tx, ty);  // dpre in the input type, as an operand
    __syncthreads();  // dpre staged; every thread is done reading dmsg of before
    float dmsg[NI][4];
    zero<NI>(dmsg);
    mm_nt<NI>(dmsg, s.dpre, s.w1, tx, ty);                  // dpre W1^T
    mm_tn<R>(dw1r, s.msg + m * kAct, s.dpre, tx, ty);  // dW1 += msg^T dpre
    float dyr[NI][4];
    load_rows<T, NI>(dyr, dy, kC, row0, end, tx, ty);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dmsg[i][j] += attn[m][i] * dyr[i][j];
        dxr[i][j] += MODE == kPacked ? round_to<T>(dmsg[i][j]) : dmsg[i][j];
      }
    put_rounded<T, NI>(s.dmsg, dmsg, tx, ty);  // dmsg in the input type, as an operand
    __syncthreads();  // dmsg staged; every thread is done reading dpre
    float acc[NI][4];
    zero<NI>(acc);
    mm_nt<NI>(acc, s.dmsg, s.v + m * kTileElems, tx, ty);  // dcar_m = dmsg V_m^T
    store_rows<T, NI>(dcar.ptr[m], dcar.stride, acc, row0, end, tx, ty);
    float dvr[4][4];
    zero<4>(dvr);
    mm_tn<R>(dvr, s.car + m * kAct, s.dmsg, tx, ty);  // dV_m += car_m^T dmsg
    float* dv = s.dv + m * kTileElems;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = dv + (4 * ty + i) * kC + 4 * tx;
      float4 o = lds4(p);
      o.x += dvr[i][0];
      o.y += dvr[i][1];
      o.z += dvr[i][2];
      o.w += dvr[i][3];
      sts4(p, o);
    }
  }
  store_rows<T, NI>(dx, kC, dxr, row0, end, tx, ty);
}

template <typename T, int M, int MODE>
__global__ void __launch_bounds__(kThreads, 1) combine_bwd_kernel(
    Carriers<T> car, const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ dy,
    CarrierGrads<T> dcar, T* __restrict__ dx, float* __restrict__ partials, int64_t P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  BwdSmem s;
  s.v = smem;                                          // [M] weight tiles
  s.w1 = s.v + M * kTileElems;                         // weight tile
  s.car = s.w1 + kTileElems;                           // [M] activation tiles
  s.msg = s.car + M * bwd_act_elems(M);                // [M] activation tiles, rounded msg_m
  s.dpre = s.msg + M * bwd_act_elems(M);               // activation tile, rounded dpre
  s.dmsg = s.dpre + bwd_act_elems(M);                  // activation tile, rounded dmsg
  s.dv = s.dmsg + bwd_act_elems(M);                    // [M] this block's dV, row-major
  float* b1_s = s.dv + M * kTileElems;
  float* w2_s = b1_s + kC;
  s.b1 = b1_s;
  s.w2 = w2_s;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int m = 0; m < M; ++m) stage_weights(s.v + m * kTileElems, v + m * kC * kC);
  stage_weights(s.w1, w1);
  for (int c = tid; c < kC; c += kThreads) {
    b1_s[c] = to_float(b1[c]);
    w2_s[c] = to_float(w2[c]);
  }
  for (int e = tid; e < M * kTileElems; e += kThreads) s.dv[e] = 0.f;
  float dw1r[4][4];
  zero<4>(dw1r);
  float db1p[4] = {0.f, 0.f, 0.f, 0.f};
  float dw2p[4] = {0.f, 0.f, 0.f, 0.f};

  // The first barrier of a tile orders the staging above before any read.
  int64_t start, end;
  row_range(P, start, end);
  int64_t row0 = start;
  if constexpr (kBwdHalfTiles<M>) {
    for (; row0 < end; row0 += kUnit)
      bwd_tile<T, M, MODE, 2>(s, car, x, dy, dcar, dx, row0, end, tx, ty, dw1r, db1p, dw2p);
  } else {
  for (; row0 + kRows <= end; row0 += kRows)
    bwd_tile<T, M, MODE, 4>(s, car, x, dy, dcar, dx, row0, end, tx, ty, dw1r, db1p, dw2p);
  if (row0 < end) {
    if (end - row0 > kUnit) {
      bwd_tile<T, M, MODE, 4>(s, car, x, dy, dcar, dx, row0, end, tx, ty, dw1r, db1p, dw2p);
    } else {
      bwd_tile<T, M, MODE, 2>(s, car, x, dy, dcar, dx, row0, end, tx, ty, dw1r, db1p, dw2p);
    }
  }
  }

  // --- this block's row of partials ---
  __syncthreads();  // every thread is done with the carrier tiles, which now hold the db1/dw2 partials
  float* red_s = s.car;  // [2][16][kC]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty * kC + 4 * tx + j] = db1p[j];
    red_s[16 * kC + ty * kC + 4 * tx + j] = dw2p[j];
  }
  __syncthreads();
  float* part = partials + (int64_t)blockIdx.x * wgrad_elems(M);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = m * kTileElems + (4 * ty + i) * kC + 4 * tx;  // owned by this thread
      store4(part + off, lds4(s.dv + off));
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(part + M * kC * kC + (4 * ty + i) * kC + 4 * tx,
         make_float4(dw1r[i][0], dw1r[i][1], dw1r[i][2], dw1r[i][3]));
  if (tid < 2 * kC) {
    const int which = tid / kC;  // 0: db1, 1: dw2
    const int c = tid % kC;
    float sum = 0.f;
    for (int r = 0; r < 16; ++r) sum += red_s[which * 16 * kC + r * kC + c];
    part[M * kC * kC + kC * kC + which * kC + c] = sum;
  }
}

// out[e] = sum over blocks, in block order, of partials[block][e], in T.
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_partials(const float* __restrict__ partials,
                                                            int blocks, int elems,
                                                            T* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int g = 0; g < blocks; ++g) s += partials[(int64_t)g * elems + e];
  out[e] = from_float<T>(s);
}

struct Args {
  const void* car[3];
  int64_t car_stride;
  const void* x;
  const void* v;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* dy;
  void* out;  // y (forward) or dx (backward)
  void* dcar[3];
  int64_t dcar_stride;
  float* partials;
  int blocks;
  void* wgrad;  // dV, dW1, db1, dw2 back to back, in T
  int64_t rows;
  cudaStream_t stream;
};

template <typename T>
Carriers<T> carriers(const Args& a) {
  Carriers<T> c;
  for (int m = 0; m < 3; ++m) c.ptr[m] = static_cast<const T*>(a.car[m]);
  c.stride = a.car_stride;
  return c;
}

// Sets the kernel's dynamic shared memory limit (once per instantiation) and
// returns how many blocks fit on the card at once, or a negated CUDA error.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem, int* cached) {
  if (*cached > 0) return *cached;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  *cached = per_sm * sms;
  return *cached;
}

// One block per 32-row unit, at most as many as fit on the card at once.
int grid_for(int resident, int64_t rows) {
  const int64_t units = (rows + kUnit - 1) / kUnit;
  return (int)(units < resident ? units : resident);
}

// The kernels read and write rows and weights as 16-byte (fp32) or 8-byte
// (bf16) vectors.
bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, int M, int MODE>
int fwd_blocks(int64_t rows) {
  static int cached = 0;
  const int resident = resident_blocks(combine_fwd_kernel<T, M, MODE>, fwd_smem_floats(M, MODE) * sizeof(float),
                                       &cached);
  return resident < 0 ? resident : grid_for(resident, rows);
}

template <typename T, int M, int MODE>
int launch_fwd(const Args& a) {
  const size_t smem = fwd_smem_floats(M, MODE) * sizeof(float);
  const int blocks = fwd_blocks<T, M, MODE>(a.rows);
  if (blocks < 0) return -blocks;
  combine_fwd_kernel<T, M, MODE><<<blocks, kThreads, smem, a.stream>>>(
      carriers<T>(a), static_cast<const T*>(a.x), static_cast<const T*>(a.v),
      static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
      static_cast<T*>(a.out), a.rows);
  return (int)cudaGetLastError();
}

template <typename T, int M, int MODE>
int bwd_blocks(int64_t rows) {
  static int cached = 0;
  const int resident = resident_blocks(combine_bwd_kernel<T, M, MODE>, bwd_smem_floats(M) * sizeof(float),
                                       &cached);
  return resident < 0 ? resident : grid_for(resident, rows);
}

template <typename T, int M, int MODE>
int launch_bwd(const Args& a) {
  const int blocks = bwd_blocks<T, M, MODE>(a.rows);
  if (blocks < 0) return -blocks;
  if (blocks != a.blocks) return (int)cudaErrorInvalidValue;  // partials sized for another grid
  CarrierGrads<T> dc;
  for (int m = 0; m < 3; ++m) dc.ptr[m] = static_cast<T*>(a.dcar[m]);
  dc.stride = a.dcar_stride;
  combine_bwd_kernel<T, M, MODE><<<blocks, kThreads, bwd_smem_floats(M) * sizeof(float), a.stream>>>(
      carriers<T>(a), static_cast<const T*>(a.x), static_cast<const T*>(a.v),
      static_cast<const T*>(a.w1), static_cast<const T*>(a.b1), static_cast<const T*>(a.w2),
      static_cast<const T*>(a.dy), dc, static_cast<T*>(a.out), a.partials, a.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = wgrad_elems(M);
  reduce_partials<T><<<(elems + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.partials, blocks, elems, static_cast<T*>(a.wgrad));
  return (int)cudaGetLastError();
}

// Backward variants: kFull at M = 1, 2, 3; kPacked at M = 2.
template <typename T>
int bwd_dispatch(int M, int mode, const Args* a, int64_t rows) {
  const bool query = a == nullptr;  // the grid size only
  if (mode == kFull) {
    switch (M) {
      case 1: return query ? bwd_blocks<T, 1, kFull>(rows) : launch_bwd<T, 1, kFull>(*a);
      case 2: return query ? bwd_blocks<T, 2, kFull>(rows) : launch_bwd<T, 2, kFull>(*a);
      case 3: return query ? bwd_blocks<T, 3, kFull>(rows) : launch_bwd<T, 3, kFull>(*a);
    }
  } else if (mode == kPacked && M == 2) {
    return query ? bwd_blocks<T, 2, kPacked>(rows) : launch_bwd<T, 2, kPacked>(*a);
  }
  return query ? -(int)cudaErrorInvalidValue : (int)cudaErrorInvalidValue;
}

// Forward variants: every mode at M = 1, 2, 3 but kPacked, at M = 2 only.
// With a == nullptr, the grid size for `rows` rows only.
template <typename T, int M, int MODE>
int fwd_one(const Args* a, int64_t rows) {
  return a == nullptr ? fwd_blocks<T, M, MODE>(rows) : launch_fwd<T, M, MODE>(*a);
}

template <typename T, int M>
int fwd_modes(int mode, const Args* a, int64_t rows) {
  switch (mode) {
    case kFull: return fwd_one<T, M, kFull>(a, rows);
    case kNoGelu: return fwd_one<T, M, kNoGelu>(a, rows);
    case kMatmul: return fwd_one<T, M, kMatmul>(a, rows);
    case kCopy: return fwd_one<T, M, kCopy>(a, rows);
    case kPacked:
      if constexpr (M == 2) return fwd_one<T, 2, kPacked>(a, rows);
      break;
  }
  return a == nullptr ? -(int)cudaErrorInvalidValue : (int)cudaErrorInvalidValue;
}

template <typename T>
int fwd_dispatch(int M, int mode, const Args* a, int64_t rows) {
  switch (M) {
    case 1: return fwd_modes<T, 1>(mode, a, rows);
    case 2: return fwd_modes<T, 2>(mode, a, rows);
    case 3: return fwd_modes<T, 3>(mode, a, rows);
  }
  return a == nullptr ? -(int)cudaErrorInvalidValue : (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; every tensor has that type and is
// contiguous. mode: 0 full, 1 packed (M = 2), 2 no-gelu, 3 matmul, 4 copy.
// car_m = car[m] + p * car_stride + c for m < M; the others may be NULL (and
// v, w1, b1, w2 where the mode does not read them). Every row and V and W1
// start on 16 bytes. Returns 0 or the first CUDA error of the launch;
// cudaErrorInvalidValue for arguments the kernels do not take,
// cudaErrorMisalignedAddress for a pointer off 16 bytes. Launches on `stream` and does not synchronise.
extern "C" int sccn_combine_fwd(const void* car0, const void* car1, const void* car2,
                                long long car_stride, const void* x, const void* v, const void* w1,
                                const void* b1, const void* w2, void* y, long long rows, int M,
                                int dtype, int mode, void* stream) {
  if (rows <= 0 || M < 1 || M > 3 || car_stride < 64 || car_stride % 8 != 0) return (int)cudaErrorInvalidValue;
  if (!aligned({car0, car1, car2, x, v, w1, y})) return (int)cudaErrorMisalignedAddress;
  Args a = {};
  a.car[0] = car0;
  a.car[1] = car1;
  a.car[2] = car2;
  a.car_stride = car_stride;
  a.x = x;
  a.v = v;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.out = y;
  a.rows = rows;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_dispatch<float>(M, mode, &a, rows);
  if (dtype == 1) return fwd_dispatch<__nv_bfloat16>(M, mode, &a, rows);
  return (int)cudaErrorInvalidValue;
}

// The number of blocks sccn_combine_fwd launches for `rows` rows, or a
// negated CUDA error for arguments the kernels do not take.
extern "C" int sccn_combine_fwd_blocks(long long rows, int M, int dtype, int mode) {
  if (rows <= 0) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return fwd_dispatch<float>(M, mode, nullptr, rows);
  if (dtype == 1) return fwd_dispatch<__nv_bfloat16>(M, mode, nullptr, rows);
  return -(int)cudaErrorInvalidValue;
}

// The number of blocks sccn_combine_bwd launches for `rows` rows: the caller
// allocates `blocks` rows of fp32 partials of M*C*C + C*C + 2C floats each.
// Returns a negated CUDA error for arguments the kernels do not take.
extern "C" int sccn_combine_bwd_blocks(long long rows, int M, int dtype, int mode) {
  if (rows <= 0) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return bwd_dispatch<float>(M, mode, nullptr, rows);
  if (dtype == 1) return bwd_dispatch<__nv_bfloat16>(M, mode, nullptr, rows);
  return -(int)cudaErrorInvalidValue;
}

// The backward: dcar_m (row stride dcar_stride, as the carriers), dx, and,
// through `partials` ([blocks][M*C*C + C*C + 2C] fp32 scratch, `blocks` from
// sccn_combine_bwd_blocks), wgrad = dV [M, C, C], dW1 [C, C], db1 [C],
// dw2 [C] back to back in the input type. Mode 0 (full) or 1 (packed, M = 2).
extern "C" int sccn_combine_bwd(const void* car0, const void* car1, const void* car2,
                                long long car_stride, const void* x, const void* v, const void* w1,
                                const void* b1, const void* w2, const void* dy, void* dcar0,
                                void* dcar1, void* dcar2, long long dcar_stride, void* dx,
                                void* partials, int blocks, void* wgrad, long long rows, int M,
                                int dtype, int mode, void* stream) {
  if (rows <= 0 || M < 1 || M > 3 || car_stride < 64 || dcar_stride < 64 || car_stride % 8 != 0 ||
      dcar_stride % 8 != 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned({car0, car1, car2, x, v, w1, dy, dcar0, dcar1, dcar2, dx})) return (int)cudaErrorMisalignedAddress;
  Args a = {};
  a.car[0] = car0;
  a.car[1] = car1;
  a.car[2] = car2;
  a.car_stride = car_stride;
  a.x = x;
  a.v = v;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.dy = dy;
  a.out = dx;
  a.dcar[0] = dcar0;
  a.dcar[1] = dcar1;
  a.dcar[2] = dcar2;
  a.dcar_stride = dcar_stride;
  a.partials = static_cast<float*>(partials);
  a.blocks = blocks;
  a.wgrad = wgrad;
  a.rows = rows;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_dispatch<float>(M, mode, &a, rows);
  if (dtype == 1) return bwd_dispatch<__nv_bfloat16>(M, mode, &a, rows);
  return (int)cudaErrorInvalidValue;
}
