// Single-pass attention in the model's [B,S,H,D] layout on Hopper
// (sm_90a): one forward kernel and ONE backward kernel that gives dQ, dK
// and dV, plain C interface.
//
// Replaces, in exp_bshd_attn.py:
//   bshd_fwd_kernel  <- _bshd_fwd_kernel  (launched by bshd_fwd)
//   bshd_bwd_kernel  <- _bshd_bwd_kernel  (launched by bshd_bwd)
//
// q, k, v, out, dO, dQ, dK, dV [B,S,H,D] in T (float32 or bfloat16), the
// residual res [B,S,H,2] float32 (m, log l) kept apart, delta [B,S,H]
// float32 (rowsum(dO * out), computed by the caller as the reference does
// outside its kernel), the key mask [B,S] float32.  Row s of head h of
// batch row b is row (b S + s) H + h of each: a block reads one head's
// rows at a stride of H D elements and writes them back in place, so the
// projections' [B,S,H*D] output needs no transpose before the op and its
// result none after it.
//
// The TPU kernels take a whole batch row (all S keys of all H heads) per
// grid step and loop over the heads inside.  Here the grid is the smalls
// pair's: a forward block per (b, h, tile of query rows), a bfloat16
// backward key and query block per (b, h, 64-row tile), a float32 one per
// (b, h); the bodies (bfloat16 on the tensor cores, float32 on the CUDA
// cores), their arithmetic, the causal skip
// and its care for fully masked rows and what bounds them are
// single_pass_attention.cuh's, with the [B,S,H,.] row order.

#include "single_pass_attention.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    bshd_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    T* __restrict__ out, float* __restrict__ res, int H,
                    int S, int D, int Dv, float scale, int causal,
                    int nq_tiles) {
  single_pass_fwd<T, R, true>(q, k, v, mask, out, res, H, S, D, Dv, scale,
                              causal, nq_tiles);
}

// the bfloat16 forward, on the tensor cores
template <int R, int kW>
__global__ void __launch_bounds__(tc_threads(R), tc_min_blocks(R, kW))
    bshd_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ mask,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ res, int H, int S, int D, int Dv,
                       float scale, int causal, int nq_tiles) {
  single_pass_fwd_tc<R, kW, true>(q, k, v, mask, out, res, H, S, D, Dv,
                                  scale, causal, nq_tiles);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bshd_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ dout,
                    const float* __restrict__ res,
                    const float* __restrict__ delta, float* dq_acc,
                    T* __restrict__ dq, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int S, int D, int Dv,
                    float scale, int causal) {
  single_pass_bwd<T, true>(q, k, v, mask, dout, res, delta, dq_acc, dq, dk,
                           dv, H, S, D, Dv, scale, causal);
}

// the bfloat16 backward, on the tensor cores: key and query blocks of 4
// warps in one grid (no dQ scratch)
template <int kW>
__global__ void __launch_bounds__(kTcThreads, dkdv_min_blocks(kW))
    bshd_bwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ res,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int S, int D,
                       int Dv, float scale, int causal, int nt) {
  single_pass_bwd_tc<kW, true>(q, k, v, mask, dout, res, delta, dq, dk, dv, H,
                               S, D, Dv, scale, causal, nt);
}

struct BshdKernels {
  template <typename T, int R, int kW>
  static fwd_kernel_t<T> fwd() {
    if constexpr (std::is_same<T, float>::value)
      return bshd_fwd_kernel<T, R>;
    else
      return bshd_fwd_kernel_tc<R, kW>;
  }
  template <typename T, int kW>
  static auto bwd() {
    if constexpr (std::is_same<T, float>::value)
      return bshd_bwd_kernel<T>;
    else
      return bshd_bwd_kernel_tc<kW>;
  }
};

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  Shapes in the layout's order: B, S, H, D.  mask may be NULL
// (every key attended).  R: the forward's blocks own 16 R query rows (1, 2
// or 4).  dq_acc is a float32 [B * H, S, D] scratch of the float32
// backward (its contents do not matter); the bfloat16 backward takes none
// (NULL will do).
#define BSHD_ENTRIES(TAG, T)                                                 \
  int bshd_fwd_##TAG(const void* q, const void* k, const void* v,            \
                     const void* mask, void* out, void* res, int B, int S,   \
                     int H, int D, float scale, int causal, int R,           \
                     void* stream) {                                         \
    return launch_fwd<BshdKernels, T>(q, k, v, mask, out, res, B, H, S, D,   \
                                      D, scale, causal, R, stream);          \
  }                                                                          \
  int bshd_bwd_##TAG(const void* q, const void* k, const void* v,            \
                     const void* mask, const void* dout, const void* res,    \
                     const void* delta, void* dq_acc, void* dq, void* dk,    \
                     void* dv, int B, int S, int H, int D, float scale,      \
                     int causal, void* stream) {                             \
    return launch_bwd<BshdKernels, T>(q, k, v, mask, dout, res, delta,       \
                                      dq_acc, dq, dk, dv, B, H, S, D, D,     \
                                      scale, causal, stream);                \
  }

BSHD_ENTRIES(f32, float)
BSHD_ENTRIES(bf16, __nv_bfloat16)

#undef BSHD_ENTRIES

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
