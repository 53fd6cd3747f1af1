// Tile helpers shared by the attention kernels (flash_attention.cu, and
// smalls_attention.cu and bshd_attention.cu through
// single_pass_attention.cuh): loads into padded float32 shared-memory
// tiles and the CUDA-core micro-tile products; round_to, the rounding of
// a float32 value to an operand type before a product; and the pieces of
// the bfloat16 tensor-core bodies (cp.async tile copies, ldmatrix,
// mma.sync m16n8k16 with float32 sums).
//
// CUDA-core bodies: 256 threads form a 16 x 16 grid: thread (ty, tx)
// owns the rows ty + 16 i (i < R) of a tile and the columns tx + 16 j of
// a 64-wide score tile (j < 4) or of an output up to 128 wide (j < 8).
// The 16 threads of a row are 16 neighbouring lanes of one warp, so row
// statistics reduce with shuffles.

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

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// ---------------------------------------------------------------------------
// bfloat16 tiles and tensor-core products (mma.sync m16n8k16).  Fragment
// layouts, for lane = 4 g + t of a warp: an A fragment (16 x 16, row
// major) holds rows g and g + 8 at columns 2t, 2t + 1 and 2t + 8, 2t + 9;
// a B fragment (16 x 8) rows 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; a
// float32 C fragment (16 x 8) rows g and g + 8 at columns 2t, 2t + 1.  So
// the C fragments of two neighbouring n8 tiles, packed to bf16, are the
// A fragment of one k16 step.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
// 4 or 8 bytes (N) from global to shared memory, asynchronously, through
// L1; src_bytes 0 fills them with zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"(N), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b over a 16 x 8 x 16 tile: bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows [r0, r0 + rows) of a bf16 matrix (row r at src + r * stride,
// `width` columns) into a shared tile [rows][ld] of bf16 whose columns
// [width, pad) are zero, as are the rows past S, by the block's kThr
// threads.  `vec`: every row starts on 16 bytes and width % 8 == 0, so
// 16-byte cp.async chunks carry it (the caller waits for its group); else
// element copies, complete at the next barrier.
template <int kThr>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long stride,
    int r0, int S, int width, int pad, int rows, bool vec) {
  if (vec) {
    const int chunks = pad / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += kThr) {
      const int r = idx / chunks, c = (idx % chunks) * 8;
      const bool live = r0 + r < S && c < width;
      cp_async16(dst + r * ld + c,
                 live ? src + (long)(r0 + r) * stride + c : src,
                 live ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * pad; idx += kThr) {
      const int r = idx / pad, c = idx % pad;
      dst[r * ld + c] = r0 + r < S && c < width
                            ? src[(long)(r0 + r) * stride + c]
                            : __float2bfloat16(0.f);
    }
  }
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

}  // namespace
