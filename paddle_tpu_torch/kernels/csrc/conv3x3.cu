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
// ms at the bf16 tensor-core peak (989 TFLOP/s); only the first stage's
// bytes (x and out once, 205.5 MB) take longer, by a hair: 0.0614 ms at
// 3.35 TB/s.
//
// The TPU kernel holds a whole [H, W, C] image in VMEM and runs nine
// shifted [H*W, C] @ [C, Co] matmuls.  A block here has at most 227 KB of
// shared memory, less than one 56x56x64 bf16 image (401 KB), so both
// bodies below are implicit GEMMs (M = output pixels, N = Co, K = 9 * C)
// with no padded copy and no im2col buffer in device memory.
//
// bfloat16: conv3x3_kernel_tc, on the tensor cores (mma.sync m16n8k16,
// bf16 products summed in float32).
//   - M spans images: a block owns kBM consecutive pixel rows of the
//     flattened (n, h, w) and kBN output channels (128 x 128 where Co >
//     64, else 256 x 64), 8 warps of 32 rows x 64 channels each, so a 7x7
//     or 14x14 stage fills its tiles;
//   - K walks tap by tap (ky, kx) in chunks of kBK = 64 input channels;
//     row r of a chunk's A tile is the pixel (h + ky - 1, w + kx - 1) of
//     row r's own image, and a source outside the image, a row past
//     N * H * W or a channel past C loads zeros: that is the padding;
//   - operands stay bf16 in shared memory, copied by 16-byte cp.async
//     with zero fill into a ring of kStages chunks (2 or 3), so the
//     copies of the next chunks overlap this chunk's products (rows of x
//     or w that are not 16-byte pieces, C or Co not a multiple of 8 or a
//     pointer off 16 bytes, take guarded element copies instead);
//   - fragments by ldmatrix: A from x's rows (channels contiguous), B
//     from w's [C][Co] slab (Co contiguous) by ldmatrix.trans;
//   - the epilogue scales, adds the bias, applies the ReLU and rounds
//     once to bf16 in the C fragments, then stages the tile in shared
//     memory so that each output row leaves in 16-byte stores.
// What limits it: latency, with 16 warps an SM (2 blocks; the 64 float32
// sums of a thread and the 128-register cap hold it there), each warp 16
// products to 6 ldmatrix a k16 step and one barrier a chunk: at 1 block
// an SM the same code runs 10-40% slower.  It reaches 200-300 TFLOP/s
// (PERF.md §6).  No wgmma, TMA im2col tensor maps or warp
// specialisation yet (the next redesign).  Each tap re-reads its A rows
// from L2 (9 x x's bytes), and a 7x7 stage at N = 256 is 98 x 4 blocks,
// 1.5 waves of 2 blocks an SM.
//
// float32: conv3x3_kernel, on the CUDA cores (float32 FMAs, 67 TFLOP/s
// peak; TF32 would break the float32 tolerance the inference chains are
// held to), the arithmetic of its port, unchanged:
//   - a block owns an 8x8 tile of output pixels of one image and 64 output
//     channels; 256 threads as 16 x 16, each 4 pixels x 4 channels of the
//     tile in float32 registers (pixels ty + 16 i, channels tx + 16 j);
//   - it walks C in chunks of 16: the 10x10 input tile with its one-pixel
//     halo (positions outside the image load 0, which is the padding) and
//     the [9, 16, 64] filter slab go to shared memory in float32, then the
//     nine taps accumulate, each a shifted read of the same halo tile;
//   - the epilogue multiplies by scale, adds bias and applies the ReLU.
// Every edge is guarded (pixels past H or W, channels past C or Co), so
// any H, W, C, Co runs.  Shared memory: 6.4 KB of input and 36.9 KB of
// filter.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kPixTile = 8;                   // output tile kPixTile^2
constexpr int kHalo = kPixTile + 2;           // input tile side with halo
constexpr int kCoTile = 64;                   // output channels a block
constexpr int kCk = 16;                       // input channels a chunk
constexpr int kF32Threads = 256;              // 16 x 16
constexpr int kPerThread = 4;                 // pixels (and channels) a thread

__global__ void __launch_bounds__(kF32Threads)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int C, int Co, int tiles_w, int relu) {
  __shared__ float xs[kHalo * kHalo][kCk];
  __shared__ float ws[9][kCk][kCoTile];

  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCoTile;
  const int h0 = (blockIdx.x / tiles_w) * kPixTile;
  const int w0 = (blockIdx.x % tiles_w) * kPixTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xn = x + (long)n * H * W * C;

  // halo offset of each of this thread's output pixels
  int hb[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = ty + 16 * i;
    hb[i] = (p / kPixTile) * kHalo + p % kPixTile;
  }
  float acc[kPerThread][kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCk) {
    for (int e = tid; e < kHalo * kHalo * kCk; e += kF32Threads) {
      const int hp = e / kCk, k = e % kCk;
      const int h = h0 - 1 + hp / kHalo, ww = w0 - 1 + hp % kHalo;
      const int c = c0 + k;
      float v = 0.f;
      if (h >= 0 && h < H && ww >= 0 && ww < W && c < C)
        v = xn[((long)h * W + ww) * C + c];
      xs[hp][k] = v;
    }
    for (int e = tid; e < 9 * kCk * kCoTile; e += kF32Threads) {
      const int tap = e / (kCk * kCoTile);
      const int k = (e / kCoTile) % kCk, j = e % kCoTile;
      const int c = c0 + k, co = co0 + j;
      float v = 0.f;
      if (c < C && co < Co) v = w[((long)tap * C + c) * Co + co];
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
    const int h = h0 + p / kPixTile, ww = w0 + p % kPixTile;
    if (h >= H || ww >= W) continue;
    float* o = out + (((long)n * H + h) * W + ww) * Co;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co >= Co) continue;
      float v = acc[i][j] * scale[co] + bias[co];
      if (relu) v = fmaxf(v, 0.f);
      o[co] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body (see the header)
// ---------------------------------------------------------------------------

constexpr int kConvWM = 32;         // rows a warp
constexpr int kConvWN = 64;         // output channels a warp
// warps an SM: the blocks an SM must hold, which caps a thread's
// registers at 128 (64 of them the warp's float32 sums)
constexpr int kConvSmWarps = 16;

// the block tile kBM x kBN (warps of kConvWM x kConvWN), its K chunks of
// kBK input channels in a ring of kStages, and its shared-memory layout
// (bf16 elements): A [kBM][kLda] and B [kBK][kLdb] a ring stage, each row
// padded by 8 so that ldmatrix's eight 16-byte rows fall in distinct
// banks; the epilogue's output tile [kBM][kLdo] reuses the ring
template <int kBM, int kBN, int kBK, int kStages>
struct ConvTile {
  static constexpr int kWarpsN = kBN / kConvWN;
  static constexpr int kWarps = kWarpsN * (kBM / kConvWM);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = kConvSmWarps / kWarps;
  static constexpr int kLda = kBK + 8;
  static constexpr int kLdb = kBN + 8;
  static constexpr int kLdo = kBN + 8;
  static constexpr int kStage = kBM * kLda + kBK * kLdb;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kElems = kRing > kBM * kLdo ? kRing : kBM * kLdo;
  static constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * kElems;
  // the copies of one chunk: 16-byte pieces of A rows and of B rows
  static constexpr int kAPieces = kBK / 8;
  static constexpr int kARowsAPass = kThreads / kAPieces;
  static constexpr int kAPasses = kBM / kARowsAPass;
  static constexpr int kBPieces = kBN / 8;
  static constexpr int kBRowsAPass = kThreads / kBPieces;
  static constexpr int kBPasses = kBK / kBRowsAPass;
  static_assert(kAPasses * kARowsAPass == kBM, "A rows split evenly");
  static_assert(kBPasses * kBRowsAPass == kBK, "B rows split evenly");
};

template <int kBM, int kBN, int kBK, int kStages>
__global__ void __launch_bounds__(
    (ConvTile<kBM, kBN, kBK, kStages>::kThreads),
    (ConvTile<kBM, kBN, kBK, kStages>::kMinBlocks))
    conv3x3_kernel_tc(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int H, int W,
                      int C, int Co, int relu, int co_tiles) {
  using L = ConvTile<kBM, kBN, kBK, kStages>;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(conv_smem);
  // the co tiles of one pixel tile run side by side: they share its rows
  const int m0 = (blockIdx.x / co_tiles) * kBM;
  const int co0 = (blockIdx.x % co_tiles) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int wm0 = (warp / L::kWarpsN) * kConvWM;
  const int wn0 = (warp % L::kWarpsN) * kConvWN;
  const bool vec_x = C % 8 == 0 && aligned16(x);
  const bool vec_w = Co % 8 == 0 && aligned16(w);

  // this thread's A rows (the same in every chunk): image row h and
  // column w of each, h far outside for a row past M
  const int ap = tid % L::kAPieces;
  const int ar = tid / L::kAPieces;
  int ah[L::kAPasses], aw[L::kAPasses];
#pragma unroll
  for (int i = 0; i < L::kAPasses; ++i) {
    const int m = m0 + ar + i * L::kARowsAPass;
    const int hw = m % (H * W);
    ah[i] = m < M ? hw / W : -4;
    aw[i] = hw % W;
  }
  const int bp = tid % L::kBPieces;
  const int br = tid / L::kBPieces;

  const int nch = (C + kBK - 1) / kBK;
  const int nk = 9 * nch;

  // chunk kt (tap kt / nch, channels from (kt % nch) * kBK) into
  // ring stage `slot`: cp.async, or element stores (complete at the
  // barrier before the chunk is read)
  auto load_chunk = [&](int kt, int slot) {
    const int tap = kt / nch;
    const int c0 = (kt - tap * nch) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* As = smem + slot * L::kStage;
    __nv_bfloat16* Bs = As + kBM * L::kLda;
    const int c = c0 + 8 * ap;
#pragma unroll
    for (int i = 0; i < L::kAPasses; ++i) {
      const int r = ar + i * L::kARowsAPass;
      const int h = ah[i] + dy, ww = aw[i] + dx;
      const bool live = h >= 0 && h < H && ww >= 0 && ww < W && c < C;
      const long src = ((long)(m0 + r) + dy * W + dx) * C + c;
      __nv_bfloat16* dst = As + r * L::kLda + 8 * ap;
      if (vec_x) {
        cp_async16(dst, live ? x + src : x, live ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = live && c + e < C ? x[src + e] : __float2bfloat16(0.f);
      }
    }
    const int co = co0 + 8 * bp;
#pragma unroll
    for (int j = 0; j < L::kBPasses; ++j) {
      const int k = br + j * L::kBRowsAPass;
      const int cc = c0 + k;
      const long src = ((long)tap * C + cc) * Co + co;
      __nv_bfloat16* dst = Bs + k * L::kLdb + 8 * bp;
      if (vec_w) {
        const bool live = cc < C && co < Co;
        cp_async16(dst, live ? w + src : w, live ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = cc < C && co + e < Co ? w[src + e]
                                         : __float2bfloat16(0.f);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(s, s);
    cp_async_commit();
  }

  // A fragments of 16 rows x 16 channels by ldmatrix, B fragments of 16
  // channels (k) x 16 output channels by ldmatrix.trans
  const int afrag = (wm0 + lane % 16) * L::kLda + (lane / 16) * 8;
  const int bfrag = (((lane / 8) % 2) * 8 + lane % 8) * L::kLdb +
                    (lane / 16) * 8 + wn0;
  float acc[kConvWM / 16][kConvWN / 8][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // chunk kt is in for every thread, and every thread is done with
    // chunk kt - 1, whose stage takes chunk kt + kStages - 1 now
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) load_chunk(next, next % kStages);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % kStages) * L::kStage;
    const __nv_bfloat16* Bs = As + kBM * L::kLda;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[kConvWM / 16][4];
#pragma unroll
      for (int mi = 0; mi < kConvWM / 16; ++mi)
        ldmatrix_x4(af[mi], As + afrag + mi * 16 * L::kLda + ks * 16);
#pragma unroll
      for (int nj = 0; nj < kConvWN / 16; ++nj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Bs + ks * 16 * L::kLdb + bfrag + 16 * nj);
#pragma unroll
        for (int mi = 0; mi < kConvWM / 16; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  __nv_bfloat16* Os = smem;
#pragma unroll
  for (int n8 = 0; n8 < kConvWN / 8; ++n8) {
    const int col = wn0 + 8 * n8 + 2 * t;
    const int co = co0 + col;
    const float s0 = co < Co ? scale[co] : 0.f;
    const float s1 = co + 1 < Co ? scale[co + 1] : 0.f;
    const float b0 = co < Co ? bias[co] : 0.f;
    const float b1 = co + 1 < Co ? bias[co + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < kConvWM / 16; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm0 + 16 * mi + g + 8 * h;
        float v0 = acc[mi][n8][2 * h] * s0 + b0;
        float v1 = acc[mi][n8][2 * h + 1] * s1 + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(Os + row * L::kLdo + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  const bool vec_out = Co % 8 == 0 && aligned16(out);
  for (int idx = tid; idx < kBM * L::kBPieces; idx += L::kThreads) {
    const int r = idx / L::kBPieces, p = idx % L::kBPieces;
    const int m = m0 + r, co = co0 + 8 * p;
    if (m >= M || co >= Co) continue;
    const __nv_bfloat16* src = Os + r * L::kLdo + 8 * p;
    __nv_bfloat16* dst = out + (long)m * Co + co;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && co + e < Co; ++e) dst[e] = src[e];
    }
  }
}

int launch_f32(const void* x, const void* w, const void* scale,
               const void* bias, void* out, int N, int H, int W, int C,
               int Co, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  if (C <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kPixTile - 1) / kPixTile;
  const long tiles = (long)((H + kPixTile - 1) / kPixTile) * tiles_w;
  const int co_tiles = (Co + kCoTile - 1) / kCoTile;
  if (tiles > 0x7fffffffL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)co_tiles, (unsigned)N);
  conv3x3_kernel<<<grid, kF32Threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)scale,
      (const float*)bias, (float*)out, H, W, C, Co, tiles_w, relu);
  return (int)cudaGetLastError();
}

template <int kBM, int kBN, int kBK, int kStages>
int launch_tc(const void* x, const void* w, const void* scale,
              const void* bias, void* out, long M, int H, int W, int C,
              int Co, int relu, void* stream) {
  using L = ConvTile<kBM, kBN, kBK, kStages>;
  const int co_tiles = (Co + kBN - 1) / kBN;
  const long blocks = (M + kBM - 1) / kBM * co_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_kernel_tc<kBM, kBN, kBK, kStages>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, L::kThreads, L::kSmemBytes,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)scale,
      (const float*)bias, (__nv_bfloat16*)out, (int)M, H, W, C, Co, relu,
      co_tiles);
  return (int)cudaGetLastError();
}

// every bf16 shape runs on the tensor cores: 256 x 64 tiles where Co fits
// one 64-wide tile (2 stages of 64-channel chunks), else 128 x 128 (3
// stages); 2 blocks an SM either way.  On an H100 these beat 32-channel
// chunks in 4 stages by 4% and 5-14%, blocks of 4 warps (4 an SM) by
// 9-40%, and 64-row warps (1 block an SM) by 10-15% (PERF.md §6)
int launch_bf16(const void* x, const void* w, const void* scale,
                const void* bias, void* out, int N, int H, int W, int C,
                int Co, int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  const long M = (long)N * H * W;
  // pixel indices (row + tap shift) stay inside an int
  if (C <= 0 || M > 0x7fffffffL - 1024L - 2L * W)
    return (int)cudaErrorInvalidValue;
  if (Co <= 64)
    return launch_tc<256, 64, 64, 2>(x, w, scale, bias, out, M, H, W, C, Co,
                                     relu, stream);
  return launch_tc<128, 128, 64, 3>(x, w, scale, bias, out, M, H, W, C, Co,
                                    relu, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() (0 = launched).  x [N, H,
// W, C] and w [3, 3, C, Co] in the named type, scale and bias [Co] float32,
// out [N, H, W, Co] in x's type; relu 0 or 1.
int conv3x3_bn_act_f32(const void* x, const void* w, const void* scale,
                       const void* bias, void* out, int N, int H, int W,
                       int C, int Co, int relu, void* stream) {
  return launch_f32(x, w, scale, bias, out, N, H, W, C, Co, relu, stream);
}

int conv3x3_bn_act_bf16(const void* x, const void* w, const void* scale,
                        const void* bias, void* out, int N, int H, int W,
                        int C, int Co, int relu, void* stream) {
  return launch_bf16(x, w, scale, bias, out, N, H, W, C, Co, relu, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
