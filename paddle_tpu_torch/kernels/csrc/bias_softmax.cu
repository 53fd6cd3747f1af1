// Bias softmax for Hopper (sm_90a), plain C interface.
//
// Replaces: _fsm_fwd_kernel in paddle_tpu/ops/attention_ops.py (launched
// by _pallas_softmax_fwd).  For attention scores x [B, H, Sq, Sk] it
// computes, over the last axis,
//     out = softmax(x + row_bias[b] + tri_bias[b, i])
// with the biases added in float32 and out written in x's dtype (float32
// or bfloat16).  row_bias is [B|1, Sk] (a padding mask per key) and
// tri_bias [B|1, Sq, Sk] (one causal or combined causal+padding plane per
// batch row); either may be absent.  A batch stride of 0 shares one bias
// across the batch.
//
// What bounds it on this card: bytes.  Each score is read once and each
// probability written once (plus the bias), for about 6 operations per
// element, far below the card's compute balance.  At the serving shape
// ([1, 2, T, T], T <= 256) the whole call moves under a megabyte, so the
// launch itself is most of its time.
//
// Design.  The TPU kernel takes a (bs, Sk) tile of rows into VMEM and
// reduces along lanes.  Here one block owns one row: its threads stride
// over the row once, add the biases and keep the float32 values in shared
// memory, so the row leaves device memory exactly once; a warp-shuffle
// plus shared-memory block reduction gives the max, a second pass over
// shared memory the exponentials and their sum, and a third writes
// e / sum.  The ragged end of the row is masked by the stride loop
// itself, so there is no Sk % 128 gate: any Sk up to 8192 (a 32 KB float32
// row, inside the 48 KB a block gets without opting in) runs.  The block has
// one thread per element up to 1024, rounded up to whole warps.

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
__global__ void bias_softmax_kernel(const T* __restrict__ x,
                                    const float* __restrict__ row_bias,
                                    long rb_bstride,
                                    const float* __restrict__ tri_bias,
                                    long tb_bstride, T* __restrict__ out,
                                    int H, int Sq, int Sk) {
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

template <typename T>
int launch(const void* x, const void* row_bias, long rb_bstride,
           const void* tri_bias, long tb_bstride, void* out, int B, int H,
           int Sq, int Sk, void* stream) {
  const long rows = (long)B * H * Sq;
  if (rows <= 0 || Sk <= 0) return 0;
  if (Sk > kMaxSk || rows > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  int threads = ((Sk + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)Sk * sizeof(float);
  bias_softmax_kernel<T><<<(unsigned)rows, threads, smem,
                           (cudaStream_t)stream>>>(
      (const T*)x, (const float*)row_bias, rb_bstride,
      (const float*)tri_bias, tb_bstride, (T*)out, H, Sq, Sk);
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
