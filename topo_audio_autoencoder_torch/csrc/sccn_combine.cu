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
// Design (simple first): persistent blocks of 256 threads walk 64-row tiles.
// Each block stages V_m, W1, b1 and w2 in shared memory as fp32 once; each
// thread owns a 4x4 micro-tile (rows ty + 16i, channels tx + 16j) of every
// [64, 64] product and runs it as scalar FMAs on the CUDA cores; a row's
// score sums its 64 channels across the 16 lanes of a half-warp by shuffles;
// the messages stay in registers until the softmax. Staged tiles have a row
// stride of C + 1 floats, so no product's shared loads conflict on a bank.
// The backward runs one block per SM (208 KB of shared memory at M = 3). It
// keeps dV in shared memory and dW1 in registers, each element owned by one
// thread, and db1/dw2 as per-thread partials reduced in a fixed order at the
// block's end; each block writes one row of fp32 partials, and
// reduce_partials sums the rows in block order: one writer per output, no
// atomics, the same result on every run. The TPU kernel's accumulation over
// its sequential grid is this loop inside a block plus the second pass.
// What this design leaves: scalar FMAs instead of wgmma, shared-memory
// operand traffic of the micro-tiles, and one or two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                   // channels: the only width built
constexpr int kRows = 64;                // rows per tile
constexpr int kThreads = 256;            // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kLd = kC + 1;              // padded row stride of a staged tile
constexpr int kTileElems = kRows * kLd;  // one staged [64, 64] tile (activations or weights)
static_assert(kRows == kC, "a staged tile holds rows or a weight matrix alike");

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

__device__ __forceinline__ float gelu(float x) {
  const float u = kSqrt2OverPi * (x + kGeluC * x * x * x);
  return 0.5f * x * (1.0f + tanhf(u));
}

__device__ __forceinline__ float gelu_grad(float x) {
  const float u = kSqrt2OverPi * (x + kGeluC * x * x * x);
  const float t = tanhf(u);
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

// Rows [row0, row0 + 64) of a [P, *] tensor into a staged fp32 tile; rows
// past P are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, const T* g, int64_t stride, int64_t row0,
                                           int64_t P) {
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC;
    const int c = e % kC;
    const int64_t row = row0 + r;
    s[r * kLd + c] = row < P ? to_float(g[row * stride + c]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage_matrix(float* s, const T* __restrict__ g) {
  for (int e = threadIdx.x; e < kC * kC; e += kThreads) s[(e / kC) * kLd + e % kC] = to_float(g[e]);
}

// A thread's micro-tile of rows [row0, row0 + 64) from global memory; rows
// past P are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float r[4][4], const T* g, int64_t stride, int64_t row0,
                                          int64_t P, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) r[i][j] = row < P ? to_float(g[row * stride + tx + 16 * j]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* g, int64_t stride, float r[4][4], int64_t row0,
                                           int64_t P, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) g[row * stride + tx + 16 * j] = from_float<T>(r[i][j]);
  }
}

__device__ __forceinline__ void zero(float a[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// acc[i][j] += sum_k a[ty + 16i][k] * b[k][tx + 16j]     (a b)
__device__ __forceinline__ void mm_nn(float acc[4][4], const float* a, const float* b, int tx,
                                      int ty) {
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k a[ty + 16i][k] * b[tx + 16j][k]     (a b^T)
__device__ __forceinline__ void mm_nt(float acc[4][4], const float* a, const float* b, int tx,
                                      int ty) {
#pragma unroll 4
  for (int k = 0; k < kC; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[r][ty + 16i] * b[r][tx + 16j]     (a^T b, over a tile's rows)
__device__ __forceinline__ void mm_tn(float acc[4][4], const float* a, const float* b, int tx,
                                      int ty) {
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r * kLd + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Writes a micro-tile into a staged tile, each value rounded to T.
template <typename T>
__device__ __forceinline__ void put_rounded(float* s, float r[4][4], int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[(ty + 16 * i) * kLd + tx + 16 * j] = round_to<T>(r[i][j]);
}

// The attention weights of each of a thread's four rows from the scores, in
// the TPU kernels' order: max, exp(s - max), their sum, exp / sum; or, packed,
// a0 = sigmoid(s0 - s1), a1 = 1 - a0.
template <int M, int MODE>
__device__ __forceinline__ void attention_weights(float s[M][4], float a[M][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
// carrier tile, the rounded-msg tile (kScore), b1 and w2 (kScore).
constexpr size_t fwd_smem_floats(int M, int mode) {
  return mode == kCopy     ? 0
         : mode == kMatmul ? (size_t)(M + 1) * kTileElems
                           : (size_t)(M + 3) * kTileElems + 2 * kC;
}

template <typename T, int M, int MODE>
__global__ void __launch_bounds__(kThreads) combine_fwd_kernel(Carriers<T> car,
                                                               const T* __restrict__ x,
                                                               const T* __restrict__ v,
                                                               const T* __restrict__ w1,
                                                               const T* __restrict__ b1,
                                                               const T* __restrict__ w2,
                                                               T* __restrict__ y, int64_t P) {
  constexpr bool kMix = MODE != kCopy;
  constexpr bool kScore = MODE == kFull || MODE == kPacked || MODE == kNoGelu;
  extern __shared__ float smem[];
  float* v_s = smem;                                    // [M][kC][kLd]
  float* w1_s = v_s + (kMix ? M * kTileElems : 0);      // [kC][kLd]
  float* car_s = w1_s + (kScore ? kTileElems : 0);      // [kRows][kLd]
  float* msg_s = car_s + kTileElems;                    // [kRows][kLd]
  float* b1_s = msg_s + kTileElems;                     // [kC]
  float* w2_s = b1_s + kC;                              // [kC]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  if constexpr (kMix) {
    for (int m = 0; m < M; ++m) stage_matrix(v_s + m * kTileElems, v + m * kC * kC);
  }
  if constexpr (kScore) {
    stage_matrix(w1_s, w1);
    for (int c = tid; c < kC; c += kThreads) {
      b1_s[c] = to_float(b1[c]);
      w2_s[c] = to_float(w2[c]);
    }
  }
  // The first __syncthreads of the tile loop orders the staging before any read.

  const int64_t tiles = (P + kRows - 1) / kRows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * kRows;
    float xr[4][4];
    load_tile(xr, x, kC, row0, P, tx, ty);

    if constexpr (MODE == kCopy) {
      // y = x + car_0 + ... + car_{M-1}, in that order.
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float cr[4][4];
        load_tile(cr, car.ptr[m], car.stride, row0, P, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xr[i][j] += cr[i][j];
      }
      store_tile(y, kC, xr, row0, P, tx, ty);
    } else if constexpr (MODE == kMatmul) {
      // y = sum_m (car_m V_m + x), accumulated from 0 in message order.
      float out[4][4];
      zero(out);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        __syncthreads();  // every thread is done with the previous carrier tile
        stage_rows(car_s, car.ptr[m], car.stride, row0, P);
        __syncthreads();
        float acc[4][4];
        zero(acc);
        mm_nn(acc, car_s, v_s + m * kTileElems, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) out[i][j] = out[i][j] + acc[i][j] + xr[i][j];
      }
      store_tile(y, kC, out, row0, P, tx, ty);
    } else {
      float msg[M][4][4];
      float score[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        __syncthreads();  // every thread is done with the previous car_s and msg_s
        stage_rows(car_s, car.ptr[m], car.stride, row0, P);
        __syncthreads();
        float acc[4][4];
        zero(acc);
        mm_nn(acc, car_s, v_s + m * kTileElems, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) msg[m][i][j] = acc[i][j] + xr[i][j];
        put_rounded<T>(msg_s, msg[m], tx, ty);  // msg in the input type, as W1's operand
        __syncthreads();
        zero(acc);
        mm_nn(acc, msg_s, w1_s, tx, ty);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float pre = acc[i][j] + b1_s[tx + 16 * j];
            const float h = MODE == kNoGelu ? pre : gelu(pre);
            part += h * w2_s[tx + 16 * j];
          }
          score[m][i] = sum16(part);
        }
      }
      float attn[M][4];
      attention_weights<M, MODE>(score, attn);
      float out[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
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
      store_tile(y, kC, out, row0, P, tx, ty);
    }
  }
}

// The backward's shared memory, in floats: V_m, W1, one carrier tile, the
// M rounded-msg tiles, the dpre/dmsg tile, the M dV accumulators, b1, w2,
// and the [2][16][kC] db1/dw2 partials of the block's end.
constexpr size_t bwd_smem_floats(int M) {
  return (size_t)(3 * M + 3) * kTileElems + 2 * kC + 2 * 16 * kC;
}

// One block's row of fp32 partials: dV [M, C, C], dW1 [C, C], db1 [C], dw2 [C].
__host__ __device__ constexpr int wgrad_elems(int M) { return M * kC * kC + kC * kC + 2 * kC; }

template <typename T, int M, int MODE>
__global__ void __launch_bounds__(kThreads, 1) combine_bwd_kernel(
    Carriers<T> car, const T* __restrict__ x, const T* __restrict__ v, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ dy,
    CarrierGrads<T> dcar, T* __restrict__ dx, float* __restrict__ partials, int64_t P) {
  extern __shared__ float smem[];
  float* v_s = smem;                       // [M][kC][kLd]
  float* w1_s = v_s + M * kTileElems;      // [kC][kLd]
  float* car_s = w1_s + kTileElems;        // [kRows][kLd]
  float* msg_s = car_s + kTileElems;       // [M][kRows][kLd], rounded msg_m
  float* d_s = msg_s + M * kTileElems;     // [kRows][kLd], rounded dpre, then dmsg
  float* dv_s = d_s + kTileElems;          // [M][kC][kLd], this block's dV
  float* b1_s = dv_s + M * kTileElems;     // [kC]
  float* w2_s = b1_s + kC;                 // [kC]
  float* red_s = w2_s + kC;                // [2][16][kC]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int m = 0; m < M; ++m) stage_matrix(v_s + m * kTileElems, v + m * kC * kC);
  stage_matrix(w1_s, w1);
  for (int c = tid; c < kC; c += kThreads) {
    b1_s[c] = to_float(b1[c]);
    w2_s[c] = to_float(w2[c]);
  }
  for (int e = tid; e < M * kTileElems; e += kThreads) dv_s[e] = 0.f;
  float dw1r[4][4];
  zero(dw1r);
  float db1p[4] = {0.f, 0.f, 0.f, 0.f};
  float dw2p[4] = {0.f, 0.f, 0.f, 0.f};

  const int64_t tiles = (P + kRows - 1) / kRows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * kRows;
    float xr[4][4], dyr[4][4];
    load_tile(xr, x, kC, row0, P, tx, ty);
    load_tile(dyr, dy, kC, row0, P, tx, ty);

    // --- recompute the forward; dattn_m = dy . msg_m with the fp32 msg ---
    float pre[M][4][4];
    float score[M][4], dattn[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      __syncthreads();  // every thread is done with car_s, msg_s and d_s of before
      stage_rows(car_s, car.ptr[m], car.stride, row0, P);
      __syncthreads();
      float acc[4][4];
      zero(acc);
      mm_nn(acc, car_s, v_s + m * kTileElems, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += xr[i][j];  // msg_m
          part += dyr[i][j] * acc[i][j];
        }
        dattn[m][i] = sum16(part);
      }
      put_rounded<T>(msg_s + m * kTileElems, acc, tx, ty);
      __syncthreads();
      zero(pre[m]);
      mm_nn(pre[m], msg_s + m * kTileElems, w1_s, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pre[m][i][j] += b1_s[tx + 16 * j];
          part += gelu(pre[m][i][j]) * w2_s[tx + 16 * j];
        }
        score[m][i] = sum16(part);
      }
    }
    float attn[M][4];
    attention_weights<M, MODE>(score, attn);

    // ds_m = attn_m (dattn_m - sum_k attn_k dattn_k); packed: +-a0 a1 (dattn_0 - dattn_1)
    float ds[M][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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

    // --- backward, message by message ---
    float dxr[4][4];
    zero(dxr);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float dpre[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float w2c = w2_s[tx + 16 * j];
          dpre[i][j] = ds[m][i] * w2c * gelu_grad(pre[m][i][j]);
          db1p[j] += dpre[i][j];
          dw2p[j] += gelu(pre[m][i][j]) * ds[m][i];
        }
      __syncthreads();  // every thread is done with d_s and car_s of before
      put_rounded<T>(d_s, dpre, tx, ty);  // dpre in the input type, as an operand
      stage_rows(car_s, car.ptr[m], car.stride, row0, P);
      __syncthreads();
      float dmsg[4][4];
      zero(dmsg);
      mm_nt(dmsg, d_s, w1_s, tx, ty);                  // dpre W1^T
      mm_tn(dw1r, msg_s + m * kTileElems, d_s, tx, ty);  // dW1 += msg^T dpre
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dmsg[i][j] += attn[m][i] * dyr[i][j];
          dxr[i][j] += MODE == kPacked ? round_to<T>(dmsg[i][j]) : dmsg[i][j];
        }
      __syncthreads();  // every thread is done reading dpre from d_s
      put_rounded<T>(d_s, dmsg, tx, ty);  // dmsg in the input type, as an operand
      __syncthreads();
      float acc[4][4];
      zero(acc);
      mm_nt(acc, d_s, v_s + m * kTileElems, tx, ty);  // dcar_m = dmsg V_m^T
      store_tile(dcar.ptr[m], dcar.stride, acc, row0, P, tx, ty);
      zero(acc);
      mm_tn(acc, car_s, d_s, tx, ty);  // dV_m += car_m^T dmsg
      float* dv = dv_s + m * kTileElems;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[(ty + 16 * i) * kLd + tx + 16 * j] += acc[i][j];
    }
    store_tile(dx, kC, dxr, row0, P, tx, ty);
  }

  // --- this block's row of partials ---
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red_s[ty * kC + tx + 16 * j] = db1p[j];
    red_s[16 * kC + ty * kC + tx + 16 * j] = dw2p[j];
  }
  __syncthreads();  // also orders dv_s's zeroing before its reads in a block without tiles
  float* part = partials + (int64_t)blockIdx.x * wgrad_elems(M);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = ty + 16 * i;
        const int b = tx + 16 * j;
        part[m * kC * kC + a * kC + b] = dv_s[m * kTileElems + a * kLd + b];  // owned by this thread
      }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[M * kC * kC + (ty + 16 * i) * kC + tx + 16 * j] = dw1r[i][j];
  if (tid < 2 * kC) {
    const int which = tid / kC;  // 0: db1, 1: dw2
    const int c = tid % kC;
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red_s[which * 16 * kC + r * kC + c];
    part[M * kC * kC + kC * kC + which * kC + c] = s;
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

int grid_for(int resident, int64_t rows) {
  const int64_t tiles = (rows + kRows - 1) / kRows;
  return (int)(tiles < resident ? tiles : resident);
}

template <typename T, int M, int MODE>
int launch_fwd(const Args& a) {
  static int cached = 0;
  const size_t smem = fwd_smem_floats(M, MODE) * sizeof(float);
  const int resident = resident_blocks(combine_fwd_kernel<T, M, MODE>, smem, &cached);
  if (resident < 0) return -resident;
  combine_fwd_kernel<T, M, MODE><<<grid_for(resident, a.rows), kThreads, smem, a.stream>>>(
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

template <typename T, int M>
int fwd_modes(int mode, const Args& a) {
  switch (mode) {
    case kFull: return launch_fwd<T, M, kFull>(a);
    case kNoGelu: return launch_fwd<T, M, kNoGelu>(a);
    case kMatmul: return launch_fwd<T, M, kMatmul>(a);
    case kCopy: return launch_fwd<T, M, kCopy>(a);
    case kPacked:
      if constexpr (M == 2) return launch_fwd<T, 2, kPacked>(a);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int fwd_dispatch(int M, int mode, const Args& a) {
  switch (M) {
    case 1: return fwd_modes<T, 1>(mode, a);
    case 2: return fwd_modes<T, 2>(mode, a);
    case 3: return fwd_modes<T, 3>(mode, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; every tensor has that type and is
// contiguous. mode: 0 full, 1 packed (M = 2), 2 no-gelu, 3 matmul, 4 copy.
// car_m = car[m] + p * car_stride + c for m < M; the others may be NULL (and
// v, w1, b1, w2 where the mode does not read them). Returns 0 or the first
// CUDA error of the launch; cudaErrorInvalidValue for arguments the kernels
// do not take. Launches on `stream` and does not synchronise.
extern "C" int sccn_combine_fwd(const void* car0, const void* car1, const void* car2,
                                long long car_stride, const void* x, const void* v, const void* w1,
                                const void* b1, const void* w2, void* y, long long rows, int M,
                                int dtype, int mode, void* stream) {
  if (rows <= 0 || M < 1 || M > 3 || car_stride < 64) return (int)cudaErrorInvalidValue;
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
  if (dtype == 0) return fwd_dispatch<float>(M, mode, a);
  if (dtype == 1) return fwd_dispatch<__nv_bfloat16>(M, mode, a);
  return (int)cudaErrorInvalidValue;
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
  if (rows <= 0 || M < 1 || M > 3 || car_stride < 64 || dcar_stride < 64 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
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
