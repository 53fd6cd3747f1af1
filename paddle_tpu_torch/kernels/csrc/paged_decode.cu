// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: _paged_decode_kernel in paddle_tpu/ops/attention_ops.py
// (launched by _pallas_paged_attention).  One query row per slot attends
// over the K/V rows [0, lens) of that slot, which live in the pages its
// page-table row lists; the result is softmax(q k^T * scale) v per head.
//
// What bounds it on this card: bytes.  Each live K/V row is read once
// (2 * lens * D * 4 bytes per slot and head) for 4 * D flops, far below
// the card's ~20 flops per byte of float32 balance, and at the serving
// shapes (8 slots, 2 heads, D = 16) the whole step moves well under a
// megabyte, so launch latency and the one dependent page-table load per
// row are what the time is made of.
//
// Design.  The TPU kernel walks the pages as a sequential grid axis and
// carries the online-softmax state in VMEM scratch between grid steps.
// Blocks on the GPU run in no order, so here one block owns one
// (slot, head) pair and a loop inside the block replaces the page axis:
// each of the block's 4 warps takes every 4th row of [0, lens), reads the
// row's page id from the slot's table row, and keeps its own running max
// m, denominator l and accumulator (D values spread over the 32 lanes,
// at most 8 a lane, so any D <= 256 fits in registers with no D % 128
// gate).  Rows at or past lens are never loaded, which masks the ragged
// tail page.  At the end the 4 partial states are merged through shared
// memory.  A dead slot (lens == 0) leaves l = 0; the 1e-30 floor on the
// denominator (the TPU kernel's l guard) turns that into a finite 0 row.
// Page ids are clamped into [0, NP) as the gather of the plain version
// does, so a bad table cannot read outside the pool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / 32;
constexpr float kMInit = -1e30f;

__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,           // [S, H*D]
                    const float* __restrict__ kc,          // [NP, PL, H*D]
                    const float* __restrict__ vc,          // [NP, PL, H*D]
                    const int32_t* __restrict__ page_table,  // [S, P]
                    const int32_t* __restrict__ lens,        // [S]
                    float* __restrict__ out,                 // [S, H*D]
                    int P, int NP, int PL, int H, int D, float scale) {
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HD = H * D;

  int n = lens[s];
  n = max(0, min(n, P * PL));
  const int32_t* pt = page_table + (size_t)s * P;
  const float* qs = q + (size_t)s * HD + (size_t)h * D;

  float qr[kPerLane];
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? qs[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kMInit;
  float l = 0.f;

  for (int t = warp; t < n; t += kWarps) {
    int page = pt[t / PL];
    page = min(max(page, 0), NP - 1);
    const size_t row = ((size_t)page * PL + (t % PL)) * HD + (size_t)h * D;
    const float* kr = kc + row;
    const float* vr = vc + row;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dot += qr[i] * kr[d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float sc = dot * scale;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = acc[i] * alpha + p * vr[d];
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxD];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  float mx = kMInit;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[kWarps];
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wgt[w] = expf(sm_m[w] - mx);
    denom += sm_l[w] * wgt[w];
  }
  denom = fmaxf(denom, 1e-30f);
  float* os = out + (size_t)s * HD + (size_t)h * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][d] * wgt[w];
    os[d] = a / denom;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int paged_decode_f32(const void* q, const void* kc, const void* vc,
                     const void* page_table, const void* lens, void* out,
                     int S, int P, int NP, int PL, int H, int D, float scale,
                     void* stream) {
  if (S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > kMaxD || P <= 0 || NP <= 0 || PL <= 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)S, (unsigned)H);
  paged_decode_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kc, (const float*)vc,
      (const int32_t*)page_table, (const int32_t*)lens, (float*)out, P, NP,
      PL, H, D, scale);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
