// The PQMF synthesis (ops/pqmf.py, PQMF.inverse) and its adjoint, for
// Hopper (sm_90a), as a polyphase product.
//
// Replaces no TPU kernel: the JAX package leaves the synthesis's strided
// transposed convolution to XLA. The port handed it to cuDNN, which ran it
// as the data gradient of a strided convolution, one tap at a time
// (dgrad2d_grouped_direct_kernel, ~62 ms of a B=128 train step).
//
// With M bands, N taps and pad = N / 2, the kept synthesis of the frames
// z [B, L, M] (frame j, band k at z[j, k]; the decoder's own layout) is,
// at frame q, sample r of the output y [B, L, M] (= [B, 1, L*M]):
//     y[q, r] = M * sum_{i < I} sum_{k < M} z[q + s - i, k] * H[i, k, r]
// where H [I, M, M] is the tap table ops/pqmf.py builds on the host,
//     H[i, k, r] = h_k[M (i - s) + r + pad]   (0 outside the taps),
// s the frame offsets that reach back, I the offsets that reach any sample
// rounded up to a multiple of kChunk with zero rows. Frames outside [0, L)
// are zero. Its adjoint, the backward, from the output's gradient gy:
//     gz[j, k] = M * sum_{i < I} sum_{r < M} gy[j - s + i, r] * H[i, k, r].
// Any M whose block fits kMaxShared bytes: up to 32 bands at the designs'
// I = 28. At the train step's shape (B = 128, L = 4,000, M = 16, N = 413:
// I = 28, s = 13) each direction is 2 * B * L * M * N = 6.8 GFLOP of
// products over 16 MB in and 16 MB out (bf16). The products are exact and
// their sum is rounded once, so either type's output is the exact
// synthesis of its inputs, correctly rounded.
//
// What bounds it on an H100 SXM: operations. The sums run in fp64 on the
// CUDA cores (34 TFLOP/s: 0.20 ms; the bytes take 0.01 ms at 3.35 TB/s):
// a product of a tap and an input, each exact in fp32, is exact in fp64,
// so each output is its exact sum (to fp64's rounding) times M, rounded
// once, to fp32 directly or, for bf16, through fp32 by round-to-odd (no
// double rounding). One fp32 accumulation chain of the 448 products (16
// bands x 28 offsets) erred three times as far from the fp64 synthesis as
// cuDNN's fp32 (0.0000151 against 0.0000047 at the train step's shape),
// and the kernels' error may be no larger than the library's. So each
// thread keeps a register tile of kFrames frames by R outputs, and feeds it
// from shared memory with 16-byte loads:
// 1. A block of kThreads threads takes `tile` frames of one batch row. It
//    stages its frames with their halo (I - 1 frames; fp64, band-major, so
//    one band's frames are contiguous; zero outside [0, L)) and the table
//    (fp32, as the host built it, exact; transposed to [I, r, k] for the
//    adjoint) in shared memory: fp32 taps keep 32 bands within a block.
// 2. Thread t owns kFrames consecutive frames and R consecutive outputs
//    (samples r, or bands k in the adjoint), R the largest of 4, 2 and 1
//    that divides M; M / R threads share a frame range, and a block runs
//    kThreads / (M / R) of them (the rest only stage). For each input band
//    (sample) and each chunk of kChunk offsets it loads the chunk's window
//    of kFrames + kChunk - 1 frames (six 16-byte loads) and kChunk rows of
//    R taps, then makes kFrames * R * kChunk fp64 FMAs (128 at R = 4).
// 3. Each output is summed in one fixed order, input band (sample) by
//    input band, offset by offset, scaled by M and rounded once on the
//    store. No atomics: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFrames = 8;   // frames a thread
constexpr int kChunk = 4;    // offsets a step; the table's offsets are a multiple of it
constexpr int kMaxShared = 232448;

template <typename T>
__device__ __forceinline__ double to_double(T v);
template <>
__device__ __forceinline__ double to_double<float>(float v) { return v; }
template <>
__device__ __forceinline__ double to_double<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

// The sum rounded once to the output's type: to fp32 to nearest; to bf16
// through fp32 rounded to odd (its 16 extra bits keep the second rounding
// the correct one).
template <typename T>
__device__ __forceinline__ T round_to(double v);
template <>
__device__ __forceinline__ float round_to<float>(double v) { return __double2float_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(double v) {
  float f = __double2float_rz(v);
  if ((double)f != v) f = __int_as_float(__float_as_int(f) | 1);
  return __float2bfloat16_rn(f);
}

// R taps of one table row, from shared memory (16-, 8- or 4-byte aligned).
template <int R>
__device__ __forceinline__ void load_taps(const float* row, double* h) {
  if constexpr (R == 4) {
    const float4 p = *reinterpret_cast<const float4*>(row);
    h[0] = p.x, h[1] = p.y, h[2] = p.z, h[3] = p.w;
  } else if constexpr (R == 2) {
    const float2 p = *reinterpret_cast<const float2*>(row);
    h[0] = p.x, h[1] = p.y;
  } else {
    h[0] = row[0];
  }
}

// A thread's outputs: the largest of 4, 2 and 1 that divides M.
int outputs_a_thread(int bands) { return bands % 4 == 0 ? 4 : bands % 2 == 0 ? 2 : 1; }

// Frames a block covers; 0 where M / R threads do not fit a block.
int tile_frames(int bands) {
  const int groups = bands / outputs_a_thread(bands);
  return groups > kThreads ? 0 : kThreads / groups * kFrames;
}

// Shared memory a block takes: (tile + offsets) frames of M values in fp64,
// and the table in fp32.
int64_t shared_bytes(int bands, int offsets) {
  return 8 * (int64_t)bands * (tile_frames(bands) + offsets) + 4 * (int64_t)offsets * bands * bands;
}

// Adjoint = false: x = z, out = y. Adjoint = true: x = gy, out = gz.
template <typename T, int R, bool Adjoint>
__global__ void __launch_bounds__(kThreads)
    synthesis_kernel(const T* __restrict__ x, const float* __restrict__ table, T* __restrict__ out, int frames,
                     int bands, int offsets, int shift, int tile, int tiles) {
  const int M = bands;
  const int width = tile + offsets;  // even: tile and offsets are
  extern __shared__ double2 shared2[];
  double* window = reinterpret_cast<double*>(shared2);  // [M][width]: input band c's frame first + f at [c][f]
  float* taps = reinterpret_cast<float*>(window + M * width);  // [offsets][M][M]: [i][k][r], or [i][r][k] in the adjoint
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * tile;
  // the first frame of the block's window: q0 + s - (I - 1), or q0 - s in the adjoint
  const int first = Adjoint ? q0 - shift : q0 + shift - offsets + 1;

  const int n_taps = offsets * M * M;
  for (int e = tid; e < n_taps; e += kThreads) {
    const int i = e / (M * M), k = (e / M) % M, r = e % M;
    taps[Adjoint ? (i * M + r) * M + k : e] = table[e];
  }
  const T* xb = x + (int64_t)b * frames * M;
  for (int e = tid; e < width * M; e += kThreads) {
    const int f = e / M, c = e % M;
    const int row = first + f;
    window[c * width + f] = row >= 0 && row < frames ? to_double(xb[(int64_t)row * M + c]) : 0.0;
  }
  __syncthreads();

  const int groups = M / R;
  if (tid >= tile / kFrames * groups) return;
  const int o0 = (tid % groups) * R;       // the thread's first output (sample r, or band k)
  const int f0 = (tid / groups) * kFrames;  // its first frame in the tile
  double acc[kFrames][R];
#pragma unroll
  for (int f = 0; f < kFrames; ++f)
#pragma unroll
    for (int o = 0; o < R; ++o) acc[f][o] = 0.0;

#pragma unroll 1
  for (int c = 0; c < M; ++c) {
    // The window of offsets i0 .. i0 + 3 starts at frame f0 + I - 4 - i0 of
    // the tile's window (forward: frame f, offset i0 + j at w[f + 3 - j]) or
    // at f0 + i0 (adjoint: at w[f + j]); both 16-byte aligned.
    const double* xc = window + c * width + f0 + (Adjoint ? 0 : offsets - kChunk);
    const float* tc = taps + c * M + o0;
#pragma unroll 1
    for (int i0 = 0; i0 < offsets; i0 += kChunk) {
      const double* src = Adjoint ? xc + i0 : xc - i0;
      double w[kFrames + kChunk];
#pragma unroll
      for (int v = 0; v < (kFrames + kChunk) / 2; ++v) {
        const double2 p = reinterpret_cast<const double2*>(src)[v];
        w[2 * v] = p.x;
        w[2 * v + 1] = p.y;
      }
      double h[kChunk][R];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) load_taps<R>(tc + (i0 + j) * M * M, h[j]);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int f = 0; f < kFrames; ++f)
#pragma unroll
          for (int o = 0; o < R; ++o)
            acc[f][o] = fma(w[Adjoint ? f + j : f + kChunk - 1 - j], h[j][o], acc[f][o]);
    }
  }

  T* ob = out + (int64_t)b * frames * M;
  const double scale = M;
#pragma unroll
  for (int f = 0; f < kFrames; ++f) {
    const int q = q0 + f0 + f;
    if (q < frames) {
#pragma unroll
      for (int o = 0; o < R; ++o) ob[(int64_t)q * M + o0 + o] = round_to<T>(acc[f][o] * scale);
    }
  }
}

template <typename T, int R, bool Adjoint>
int launch(const void* x, const float* table, void* out, int batch, int frames, int bands, int offsets, int shift,
           cudaStream_t stream) {
  const int bytes = (int)shared_bytes(bands, offsets);
  const int tile = tile_frames(bands);
  const int tiles = (frames + tile - 1) / tile;
  if ((int64_t)tiles * batch > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = synthesis_kernel<T, R, Adjoint>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<tiles * batch, kThreads, bytes, stream>>>(static_cast<const T*>(x), table, static_cast<T*>(out),
                                                     frames, bands, offsets, shift, tile, tiles);
  return (int)cudaGetLastError();
}

template <typename T, bool Adjoint>
int dispatch(const void* x, const float* table, void* out, int batch, int frames, int bands, int offsets, int shift,
             cudaStream_t stream) {
  switch (outputs_a_thread(bands)) {
    case 4: return launch<T, 4, Adjoint>(x, table, out, batch, frames, bands, offsets, shift, stream);
    case 2: return launch<T, 2, Adjoint>(x, table, out, batch, frames, bands, offsets, shift, stream);
    default: return launch<T, 1, Adjoint>(x, table, out, batch, frames, bands, offsets, shift, stream);
  }
}

}  // namespace

// The constants the wrapper checks shapes with; it refuses a library whose
// constants differ from its own.
extern "C" void pqmf_synthesis_limits(int* threads, int* frames, int* chunk, int* max_shared) {
  *threads = kThreads;
  *frames = kFrames;
  *chunk = kChunk;
  *max_shared = kMaxShared;
}

// The synthesis (adjoint = 0: x = z [B, L, M] -> out = y [B, L, M]) or its
// adjoint (adjoint = 1: x = gy -> out = gz), both contiguous in the type
// `dtype` (0 fp32, 1 bf16), through `table` [offsets, M, M] fp32. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() (0 =
// cudaSuccess) or cudaErrorInvalidValue for a shape it does not take (M
// below 1, offsets not a positive multiple of kChunk, a block's window and
// table over kMaxShared bytes).
extern "C" int pqmf_synthesis(int adjoint, const void* x, const float* table, void* out, int batch, int frames,
                              int bands, int offsets, int shift, int dtype, void* stream) {
  if (batch < 1 || frames < 1 || bands < 1 || offsets < kChunk || offsets % kChunk != 0 || shift < 0 ||
      shift >= offsets || tile_frames(bands) == 0 || shared_bytes(bands, offsets) > kMaxShared)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return adjoint ? dispatch<float, true>(x, table, out, batch, frames, bands, offsets, shift, s)
                   : dispatch<float, false>(x, table, out, batch, frames, bands, offsets, shift, s);
  if (dtype == 1)
    return adjoint ? dispatch<__nv_bfloat16, true>(x, table, out, batch, frames, bands, offsets, shift, s)
                   : dispatch<__nv_bfloat16, false>(x, table, out, batch, frames, bands, offsets, shift, s);
  return (int)cudaErrorInvalidValue;
}
