// Tile helpers shared by the attention kernels (flash_attention.cu, and
// smalls_attention.cu and bshd_attention.cu through
// single_pass_attention.cuh): loads into padded float32 shared-memory
// tiles and the CUDA-core micro-tile products.
//
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns the rows
// ty + 16 i (i < R) of a tile and the columns tx + 16 j of a 64-wide score
// tile (j < 4) or of an output up to 128 wide (j < 8).  The 16 threads of
// a row are 16 neighbouring lanes of one warp, so row statistics reduce
// with shuffles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // key tile (and the flash kernels' query tile)
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxD = 128;     // head width limit (8 output columns a thread)
constexpr float kNegInf = -1e9f;
// a row max below this has seen only masked keys (see the causal skip)
constexpr float kAllMasked = -5e8f;

__device__ __forceinline__ float load_f(const float* p, long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Reduce over the 16 lanes that share a row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + rows) of an [S, width] matrix whose row r starts at
// src + r * stride into shared memory as float32 with a row stride of
// width + 1; rows past S are zero
template <typename T>
__device__ void load_tile_strided(float* dst, const T* src, long stride,
                                  int r0, int S, int width,
                                  int rows = kTile) {
  const int ld = width + 1;
  for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
    const int r = idx / width, c = idx % width;
    const int gr = r0 + r;
    dst[r * ld + c] = gr < S ? load_f(src, (long)gr * stride + c) : 0.f;
  }
}

// the same for a dense [S, width] matrix
template <typename T>
__device__ void load_tile(float* dst, const T* src, int r0, int S, int width,
                          int rows = kTile) {
  load_tile_strided(dst, src, (long)width, r0, S, width, rows);
}

// additive key bias of the keys [k0, k0 + n): 0 or (1 - mask) * NEG_INF
// for a real key, -inf past Sk
__device__ void load_key_bias(float* dst, const float* mask, int k0, int Sk,
                              int n = kTile) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int kc = k0 + j;
    dst[j] = kc >= Sk ? -INFINITY
                      : (mask ? (1.f - mask[kc]) * kNegInf : 0.f);
  }
}

// acc[i][j] += sum_d A[row_i][d] * B[col_j][d] for the R x 4 score
// micro-tile (rows ty + 16 i of A, rows tx + 16 j of B, both [.][w + 1])
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][4], const float* A,
                                         const float* Bm, int width, int ty,
                                         int tx) {
  const int ld = width + 1;
  for (int d = 0; d < width; ++d) {
    float a[R], b[4];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][jd] += sum_t P[row_i][t] * V[t][tx + 16 jd] over a 64-deep tile,
// with P rows ty + 16 i at a row stride of ldp and V [64][width + 1]
template <int R>
__device__ __forceinline__ void tile_mul(float (&acc)[R][8], const float* P,
                                         int ldp, const float* V, int width,
                                         int ty, int tx) {
  const int ld = width + 1;
  for (int t = 0; t < kTile; ++t) {
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = P[(ty + 16 * i) * ldp + t];
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int c = tx + 16 * jd;
      if (c < width) {
        const float vv = V[t * ld + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][jd] = fmaf(p[i], vv, acc[i][jd]);
      }
    }
  }
}

}  // namespace
