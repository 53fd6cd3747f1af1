// 3x3 convolution with a folded batch norm and ReLU, for Hopper (sm_90a),
// plain C interface.
//
// Replaces: _conv3x3_kernel in exp_resnet_conv.py (launched by
// pallas_conv3x3), ResNet-50's 3x3 body.  For x [N, H, W, C] (NHWC) and a
// filter w [3, 3, C, Co] (HWIO), both float32 or bfloat16, and float32
// scale and bias [Co], it computes the stride-1 convolution with a zero
// padding of one pixel, accumulated in float32, then
//     out = acc * scale + bias,   ReLU if asked,
// rounded once to x's dtype and written NHWC [N, H, W, Co].  With a batch
// norm folded in, scale = gamma * rsqrt(var + eps) and bias = beta -
// mean * scale.
//
// What bounds it on this card: operations.  A ResNet-50 body at N = 256
// does 2 * N * H * W * C * Co * 9 = 5.92e10 of them at every stage, 0.0598
// ms at the bf16 tensor-core peak; only the first stage's bytes (x and
// out once, 205.5 MB) take longer, 0.0614 ms.  This kernel does its
// products on the CUDA cores (float32 FMAs, 67 TFLOP/s peak), so it sits
// far above that bound; tensor cores (wgmma, TMA) are later work.
//
// Design.  The TPU kernel holds a whole [H, W, C] image in VMEM and runs
// nine shifted [H*W, C] @ [C, Co] matmuls.  A block here has at most 227 KB
// of shared memory, less than one 56x56x64 bf16 image (401 KB), so it is an
// implicit GEMM (M = output pixels, N = Co, K = 9 * C) with no padded copy
// and no im2col buffer in device memory:
//   - a block owns an 8x8 tile of output pixels of one image and 64 output
//     channels; 256 threads as 16 x 16, each 4 pixels x 4 channels of the
//     tile in float32 registers (pixels ty + 16 i, channels tx + 16 j);
//   - it walks C in chunks of 16: the 10x10 input tile with its one-pixel
//     halo (positions outside the image load 0, which is the padding) and
//     the [9, 16, 64] filter slab go to shared memory in float32, then the
//     nine taps accumulate, each a shifted read of the same halo tile;
//   - the epilogue multiplies by scale, adds bias, applies the ReLU and
//     rounds once to the output type.
// Every edge is guarded (pixels past H or W, channels past C or Co), so
// any H, W, C, Co runs: ResNet-50's 7x7 last stage fills 49 of a tile's 64
// pixels.  Shared memory: 6.4 KB of input and 36.9 KB of filter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                      // output tile kTile x kTile
constexpr int kHalo = kTile + 2;              // input tile side with halo
constexpr int kPix = kTile * kTile;           // output pixels a block
constexpr int kCoTile = 64;                   // output channels a block
constexpr int kCk = 16;                       // input channels a chunk
constexpr int kThreads = 256;                 // 16 x 16
constexpr int kPerThread = 4;                 // pixels (and channels) a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int H, int W, int C, int Co, int tiles_w, int relu) {
  __shared__ float xs[kHalo * kHalo][kCk];
  __shared__ float ws[9][kCk][kCoTile];

  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCoTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* xn = x + (long)n * H * W * C;

  // halo offset of each of this thread's output pixels
  int hb[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = ty + 16 * i;
    hb[i] = (p / kTile) * kHalo + p % kTile;
  }
  float acc[kPerThread][kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCk) {
    for (int e = tid; e < kHalo * kHalo * kCk; e += kThreads) {
      const int hp = e / kCk, k = e % kCk;
      const int h = h0 - 1 + hp / kHalo, ww = w0 - 1 + hp % kHalo;
      const int c = c0 + k;
      float v = 0.f;
      if (h >= 0 && h < H && ww >= 0 && ww < W && c < C)
        v = to_f(xn[((long)h * W + ww) * C + c]);
      xs[hp][k] = v;
    }
    for (int e = tid; e < 9 * kCk * kCoTile; e += kThreads) {
      const int tap = e / (kCk * kCoTile);
      const int k = (e / kCoTile) % kCk, j = e % kCoTile;
      const int c = c0 + k, co = co0 + j;
      float v = 0.f;
      if (c < C && co < Co) v = to_f(w[((long)tap * C + c) * Co + co]);
      ws[tap][k][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kHalo + tap % 3;
#pragma unroll 4
      for (int k = 0; k < kCk; ++k) {
        float a[kPerThread], b[kPerThread];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i) a[i] = xs[hb[i] + shift][k];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) b[j] = ws[tap][k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = ty + 16 * i;
    const int h = h0 + p / kTile, ww = w0 + p % kTile;
    if (h >= H || ww >= W) continue;
    T* o = out + (((long)n * H + h) * W + ww) * Co;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co >= Co) continue;
      float v = acc[i][j] * scale[co] + bias[co];
      if (relu) v = fmaxf(v, 0.f);
      o[co] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int N, int H, int W, int C, int Co, int relu,
           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  if (C <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTile - 1) / kTile;
  const long tiles = (long)((H + kTile - 1) / kTile) * tiles_w;
  const int co_tiles = (Co + kCoTile - 1) / kCoTile;
  if (tiles > 0x7fffffffL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)co_tiles, (unsigned)N);
  conv3x3_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const float*)scale, (const float*)bias,
      (T*)out, H, W, C, Co, tiles_w, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() (0 = launched).  x [N, H,
// W, C] and w [3, 3, C, Co] in the named type, scale and bias [Co] float32,
// out [N, H, W, Co] in x's type; relu 0 or 1.
int conv3x3_bn_act_f32(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W,
                       int C, int Co, int relu, void* stream) {
  return launch<float>(x, w, scale, bias, out, N, H, W, C, Co, relu, stream);
}

int conv3x3_bn_act_bf16(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int N, int H, int W,
                        int C, int Co, int relu, void* stream) {
  return launch<__nv_bfloat16>(x, w, scale, bias, out, N, H, W, C, Co, relu,
                               stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
