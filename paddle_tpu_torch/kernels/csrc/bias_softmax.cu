// Bias softmax and its backward for Hopper (sm_90a), plain C interface.
//
// Forward.  Replaces: _fsm_fwd_kernel in paddle_tpu/ops/attention_ops.py
// (launched by _pallas_softmax_fwd).  For attention scores x [B, H, Sq, Sk] it
// computes, over the last axis,
//     out = softmax(x + row_bias[b] + tri_bias[b, i])
// with the biases added in float32 and out written in x's dtype (float32
// or bfloat16).  row_bias is [B|1, Sk] (a padding mask per key) and
// tri_bias [B|1, Sq, Sk] (one causal or combined causal+padding plane per
// batch row); either may be absent.  A batch stride of 0 shares one bias
// across the batch.
//
// What bounds it on this card: bytes.  Each score is read once and each
// probability written once (the biases are shared across heads and stay
// in L2), for about 6 operations per element, far below the card's
// compute balance: route A's [64, 8, 256, 256] bf16 scores with a row
// bias move 134 MB, 0.040 ms at 3.35 TB/s.  At the serving shape
// ([1, 2, T, T], T <= 256) the whole call moves under a megabyte, so the
// launch itself is most of its time.
//
// Design.  The TPU kernel takes a (bs, Sk) tile of rows into VMEM and
// reduces along lanes.  Its first port here gave each row a block of one
// thread per element, staged the row in shared memory and reduced it
// through two block reductions: at Sk 256 that is 131072 blocks of 256
// threads, 2-byte loads and six barriers a row, paced by the blocks' fixed
// cost (0.44 TB/s).  Now, for Sk <= 1024, one warp owns one row
// (kRowWarps rows a block) and each lane keeps its share of the row in
// registers: KP pieces of VEC values, piece p of the row on lane p % 32,
// so neighbouring lanes read neighbouring pieces.  Where the row is made of
// 16-byte pieces that start on 16-byte boundaries (Sk % 8 == 0 in bf16,
// Sk % 4 == 0 in float32, every pointer aligned) a piece is one 16-byte
// load of x (8 bf16 or 4 float32 values), its biases float4 loads and its
// output one 16-byte store; any other row takes the element body (VEC 1:
// one value a piece), which runs the same code.  Max and sum are taken
// by __shfl_xor_sync alone: no shared memory, no barrier.  The arithmetic
// is the old body's, float32 bias adds in the same order, expf(v - max)
// and a float32 sum, but for e * (1 / sum) in place of e / sum (within
// 1.5 ulp of it).  A row whose keys are all masked (-1e9) has
// equal values and gives the uniform row.  KP is a compile-time count
// (a power of two: the loops unroll), chosen with the body by pick_body
// from Sk, the dtype and the alignment alone, as the wrapper's
// bias_softmax_body does.  Rows of 1024 < Sk <= 8192 keep the block body
// (bias_softmax_block_kernel): one block a row, the row in shared memory
// (a 32 KB float32 row fits the 48 KB a block gets without opting in).
//
// Backward.  Replaces: _fsm_bwd_kernel in paddle_tpu/ops/attention_ops.py
// (launched by _pallas_softmax_bwd).  For the saved probabilities y and
// their cotangent dy (each float32 or bfloat16; dy is read at its OWN
// dtype, float32 under AMP, because dx is made of the small differences
// between dy's entries that a bf16 cast of dy would destroy) it computes
//     dx = (dy - sum_j dy_j * y_j) * y
// with dx written in y's dtype.  Bound: bytes — y and dy read once, dx
// written once, 3 operations an element.  Design: one block per row; each
// thread keeps its strided elements of y and dy in registers (at most 8,
// so rows up to 8192 with 1024 threads), one block reduction gives the
// dot product, and the same registers give dx: each element leaves device
// memory once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSk = 8192;

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

// Reduce v over the block (max when is_max, else sum); every thread gets
// the result.  blockDim.x is a multiple of 32.
__device__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <typename T>
__global__ void bias_softmax_block_kernel(const T* __restrict__ x,
                                          const float* __restrict__ row_bias,
                                          long rb_bstride,
                                          const float* __restrict__ tri_bias,
                                          long tb_bstride,
                                          T* __restrict__ out, int H, int Sq,
                                          int Sk) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long r = blockIdx.x;  // row of the flattened [B*H*Sq, Sk] scores
  const int i = (int)(r % Sq);
  const int b = (int)(r / Sq / H);
  const T* xr = x + r * Sk;
  T* orow = out + r * Sk;
  const float* rb = row_bias ? row_bias + b * rb_bstride : nullptr;
  const float* tb = tri_bias ? tri_bias + b * tb_bstride + (long)i * Sk
                             : nullptr;

  float mx = -INFINITY;
  for (int j = threadIdx.x; j < Sk; j += blockDim.x) {
    float v = load_f(xr, j);
    if (rb) v += rb[j];
    if (tb) v += tb[j];
    row[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce(mx, red, true);

  float sum = 0.f;
  for (int j = threadIdx.x; j < Sk; j += blockDim.x) {
    const float e = expf(row[j] - mx);
    row[j] = e;
    sum += e;
  }
  sum = block_reduce(sum, red, false);

  for (int j = threadIdx.x; j < Sk; j += blockDim.x)
    store_f(orow, j, row[j] / sum);
}

// ---- the warp-per-row body --------------------------------------------

constexpr int kWarpMaxSk = 1024;  // longest row a warp keeps in registers
constexpr int kRowWarps = 4;      // warps a block (4, 8 and 16 within 3%)

// VEC values of piece p of a row: one 16-byte load where VEC * sizeof(T)
// is 16, else VEC element loads (VEC 1, the element body).
template <int VEC>
__device__ __forceinline__ void load_piece(const float* p, long piece,
                                           float* v) {
  if constexpr (VEC == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[piece];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[piece * VEC + e];
  }
}

template <int VEC>
__device__ __forceinline__ void load_piece(const __nv_bfloat16* p,
                                           long piece, float* v) {
  if constexpr (VEC == 8) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[piece];
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = __bfloat162float(p[piece * VEC + e]);
  }
}

// add the float32 bias values of piece p: float4 loads where VEC is a
// multiple of 4 (the row then starts on a 16-byte boundary)
template <int VEC>
__device__ __forceinline__ void add_bias(const float* b, long piece,
                                         float* v) {
  if constexpr (VEC % 4 == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(b + piece * VEC);
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e) {
      const float4 a = b4[e];
      v[4 * e] += a.x; v[4 * e + 1] += a.y;
      v[4 * e + 2] += a.z; v[4 * e + 3] += a.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] += b[piece * VEC + e];
  }
}

template <int VEC>
__device__ __forceinline__ void store_piece(float* p, long piece,
                                            const float* v) {
  if constexpr (VEC == 4) {
    reinterpret_cast<float4*>(p)[piece] =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[piece * VEC + e] = v[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store_piece(__nv_bfloat16* p, long piece,
                                            const float* v) {
  if constexpr (VEC == 8) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(p)[piece] = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      p[piece * VEC + e] = __float2bfloat16(v[e]);
  }
}

// One warp a row, kRowWarps rows a block.  Lane l holds pieces l, l + 32,
// ..., l + 32 (KP - 1) of the row (VEC values each) in registers.
template <typename T, int VEC, int KP>
__global__ void __launch_bounds__(kRowWarps * 32)
bias_softmax_warp_kernel(const T* __restrict__ x,
                         const float* __restrict__ row_bias, long rb_bstride,
                         const float* __restrict__ tri_bias, long tb_bstride,
                         T* __restrict__ out, int H, int Sq, int Sk,
                         int rows) {
  const long rl = (long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (rl >= rows) return;  // whole warps leave: no barrier below
  const int r = (int)rl;   // 32-bit index arithmetic: rows < 2^31
  const int lane = threadIdx.x % 32;
  const int i = r % Sq;
  const int b = r / Sq / H;
  const T* xr = x + rl * Sk;
  T* orow = out + rl * Sk;
  const float* rb = row_bias ? row_bias + b * rb_bstride : nullptr;
  const float* tb = tri_bias ? tri_bias + b * tb_bstride + (long)i * Sk
                             : nullptr;
  const int pieces = Sk / VEC;

  float v[KP][VEC];
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = lane + 32 * k;
    if (p < pieces) {
      load_piece<VEC>(xr, p, v[k]);
      if (rb) add_bias<VEC>(rb, p, v[k]);
      if (tb) add_bias<VEC>(tb, p, v[k]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) mx = fmaxf(mx, v[k][e]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (lane + 32 * k < pieces) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[k][e] = expf(v[k][e] - mx);
        sum += v[k][e];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);

  // e * (1 / sum): one correctly rounded reciprocal a row, then a
  // product, at most 1.5 ulp (2e-7) from e / sum, far inside the 1e-5
  // float32 tolerance, where an IEEE division an element costs ~10
  // instructions
  const float inv = 1.f / sum;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = lane + 32 * k;
    if (p < pieces) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] *= inv;
      store_piece<VEC>(orow, p, v[k]);
    }
  }
}

// The body a row takes, by shape alone (the wrapper's bias_softmax_body
// states the same rule): 0 = block body, else the warp body with
// `*vec` values a piece and `*kp` pieces a lane.
int pick_body(int Sk, int elem_bytes, bool aligned, int* vec, int* kp) {
  if (Sk > kWarpMaxSk) return 0;
  const int piece = 16 / elem_bytes;
  *vec = aligned && Sk % piece == 0 ? piece : 1;
  const int per_lane = (Sk / *vec + 31) / 32;
  *kp = 1;
  while (*kp < per_lane) *kp *= 2;
  return 1;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// launch the warp body with KP = kp (a power of two up to what a row of
// kWarpMaxSk needs at this VEC; pick_body gives no larger one)
template <typename T, int VEC, int KP = 1>
void launch_warp_body(int kp, const T* x, const float* rb, long rb_bstride,
                      const float* tb, long tb_bstride, T* out, int H, int Sq,
                      int Sk, long rows, cudaStream_t stream) {
  if (kp > KP) {
    if constexpr (KP * VEC * 32 < kWarpMaxSk)
      launch_warp_body<T, VEC, 2 * KP>(kp, x, rb, rb_bstride, tb, tb_bstride,
                                       out, H, Sq, Sk, rows, stream);
    return;
  }
  const long blocks = (rows + kRowWarps - 1) / kRowWarps;
  bias_softmax_warp_kernel<T, VEC, KP>
      <<<(unsigned)blocks, kRowWarps * 32, 0, stream>>>(
          x, rb, rb_bstride, tb, tb_bstride, out, H, Sq, Sk, (int)rows);
}

template <typename T>
int launch(const void* x, const void* row_bias, long rb_bstride,
           const void* tri_bias, long tb_bstride, void* out, int B, int H,
           int Sq, int Sk, void* stream) {
  const long rows = (long)B * H * Sq;
  if (rows <= 0 || Sk <= 0) return 0;
  if (Sk > kMaxSk || rows > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(x) && aligned16(out) &&
                       aligned16(row_bias) && aligned16(tri_bias);
  int vec = 1, kp = 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pick_body(Sk, (int)sizeof(T), aligned, &vec, &kp)) {
    const T* xp = (const T*)x;
    const float* rb = (const float*)row_bias;
    const float* tb = (const float*)tri_bias;
    T* op = (T*)out;
    if (vec == 1)
      launch_warp_body<T, 1>(kp, xp, rb, rb_bstride, tb, tb_bstride, op, H,
                             Sq, Sk, rows, st);
    else
      launch_warp_body<T, (int)(16 / sizeof(T))>(
          kp, xp, rb, rb_bstride, tb, tb_bstride, op, H, Sq, Sk, rows, st);
    return (int)cudaGetLastError();
  }
  int threads = ((Sk + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)Sk * sizeof(float);
  bias_softmax_block_kernel<T><<<(unsigned)rows, threads, smem, st>>>(
      (const T*)x, (const float*)row_bias, rb_bstride,
      (const float*)tri_bias, tb_bstride, (T*)out, H, Sq, Sk);
  return (int)cudaGetLastError();
}

constexpr int kMaxPer = 8;  // row elements a thread keeps in registers

template <typename TY, typename TD>
__global__ void bias_softmax_grad_kernel(const TY* __restrict__ y,
                                         const TD* __restrict__ dy,
                                         TY* __restrict__ dx, int Sk) {
  __shared__ float red[32];
  const long r = blockIdx.x;
  const TY* yr = y + r * Sk;
  const TD* dyr = dy + r * Sk;
  TY* dxr = dx + r * Sk;
  float yv[kMaxPer], dv[kMaxPer];
  float dot = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int j = threadIdx.x + t * blockDim.x;
    yv[t] = 0.f;
    dv[t] = 0.f;
    if (j < Sk) {
      yv[t] = load_f(yr, j);
      dv[t] = load_f(dyr, j);
      dot += yv[t] * dv[t];
    }
  }
  dot = block_reduce(dot, red, false);
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int j = threadIdx.x + t * blockDim.x;
    if (j < Sk) store_f(dxr, j, (dv[t] - dot) * yv[t]);
  }
}

template <typename TY, typename TD>
int launch_grad(const void* y, const void* dy, void* dx, long rows, int Sk,
                void* stream) {
  if (rows <= 0 || Sk <= 0) return 0;
  if (Sk > kMaxSk || rows > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // about 4 elements a thread, whole warps, at most 1024 threads (and so
  // at most kMaxPer = 8 elements a thread at Sk = 8192)
  int threads = (((Sk + 3) / 4 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads * kMaxPer < Sk) return (int)cudaErrorInvalidValue;
  bias_softmax_grad_kernel<TY, TD><<<(unsigned)rows, threads, 0,
                                     (cudaStream_t)stream>>>(
      (const TY*)y, (const TD*)dy, (TY*)dx, Sk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() (0 = launched).
// row_bias / tri_bias may be NULL; their batch strides are in elements.
int bias_softmax_f32(const void* x, const void* row_bias, long rb_bstride,
                     const void* tri_bias, long tb_bstride, void* out, int B,
                     int H, int Sq, int Sk, void* stream) {
  return launch<float>(x, row_bias, rb_bstride, tri_bias, tb_bstride, out,
                       B, H, Sq, Sk, stream);
}

int bias_softmax_bf16(const void* x, const void* row_bias, long rb_bstride,
                      const void* tri_bias, long tb_bstride, void* out, int B,
                      int H, int Sq, int Sk, void* stream) {
  return launch<__nv_bfloat16>(x, row_bias, rb_bstride, tri_bias, tb_bstride,
                               out, B, H, Sq, Sk, stream);
}

// Backward: dx = (dy - sum(dy * y)) * y over rows of Sk; y and dx share
// a dtype (the first tag), dy has its own (the second).
int bias_softmax_grad_f32_f32(const void* y, const void* dy, void* dx,
                              long rows, int Sk, void* stream) {
  return launch_grad<float, float>(y, dy, dx, rows, Sk, stream);
}

int bias_softmax_grad_f32_bf16(const void* y, const void* dy, void* dx,
                               long rows, int Sk, void* stream) {
  return launch_grad<float, __nv_bfloat16>(y, dy, dx, rows, Sk, stream);
}

int bias_softmax_grad_bf16_f32(const void* y, const void* dy, void* dx,
                               long rows, int Sk, void* stream) {
  return launch_grad<__nv_bfloat16, float>(y, dy, dx, rows, Sk, stream);
}

int bias_softmax_grad_bf16_bf16(const void* y, const void* dy, void* dx,
                                long rows, int Sk, void* stream) {
  return launch_grad<__nv_bfloat16, __nv_bfloat16>(y, dy, dx, rows, Sk,
                                                    stream);
}

// The forward body pick_body gives a row of Sk values of elem_bytes
// bytes (0 = the block body, 1 = the warp body with *vec values a piece
// and *kp pieces a lane): for the card tests that hold the wrapper's
// bias_softmax_body to this rule.
int bias_softmax_pick_body(int Sk, int elem_bytes, int aligned, int* vec,
                           int* kp) {
  *vec = 1;
  *kp = 0;
  return pick_body(Sk, elem_bytes, aligned != 0, vec, kp);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
