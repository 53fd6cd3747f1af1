// Single-pass attention for Sq == Sk on Hopper (sm_90a) in the [B,H,S,D]
// layout: one forward kernel and ONE backward kernel that gives dQ, dK and
// dV, plain C interface.
//
// Replaces, in paddle_tpu/ops/attention_ops.py:
//   smalls_fwd_kernel  <- _smalls_fwd_kernel  (launched by _smalls_attention)
//   smalls_bwd_kernel  <- _smalls_bwd_kernel  (launched by _smalls_attention_bwd)
// and the same two bodies in exp_smalls_attn.py.
//
// q, k [B,H,S,D], v [B,H,S,Dv], out [B,H,S,Dv], lse [B,H,S,2] float32,
// delta [B,H,S].  What they compute, what bounds them and how they are
// built (bfloat16 on the tensor cores, float32 on the CUDA cores):
// single_pass_attention.cuh, whose bodies they run with the
// [B,H,S,.] layout (bshd_attention.cu runs the same bodies on [B,S,H,D]).

#include "single_pass_attention.cuh"

namespace {

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    smalls_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      T* __restrict__ out, float* __restrict__ lse, int H,
                      int S, int D, int Dv, float scale, int causal,
                      int nq_tiles) {
  single_pass_fwd<T, R, false>(q, k, v, mask, out, lse, H, S, D, Dv, scale,
                               causal, nq_tiles);
}

// the bfloat16 forward, on the tensor cores
template <int R, int kW>
__global__ void __launch_bounds__(tc_threads(R), tc_min_blocks(R, kW))
    smalls_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int H, int S, int D,
                         int Dv, float scale, int causal, int nq_tiles) {
  single_pass_fwd_tc<R, kW, false>(q, k, v, mask, out, lse, H, S, D, Dv,
                                   scale, causal, nq_tiles);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    smalls_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* dq_acc,
                      T* __restrict__ dq, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int S, int D, int Dv,
                      float scale, int causal) {
  single_pass_bwd<T, false>(q, k, v, mask, dout, lse, delta, dq_acc, dq, dk,
                            dv, H, S, D, Dv, scale, causal);
}

// the bfloat16 backward, on the tensor cores: key and query blocks of 4
// warps in one grid (no dQ scratch)
template <int kW>
__global__ void __launch_bounds__(kTcThreads, dkdv_min_blocks(kW))
    smalls_bwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int S, int D,
                         int Dv, float scale, int causal, int nt) {
  single_pass_bwd_tc<kW, false>(q, k, v, mask, dout, lse, delta, dq, dk, dv, H,
                                S, D, Dv, scale, causal, nt);
}

struct SmallsKernels {
  template <typename T, int R, int kW>
  static fwd_kernel_t<T> fwd() {
    if constexpr (std::is_same<T, float>::value)
      return smalls_fwd_kernel<T, R>;
    else
      return smalls_fwd_kernel_tc<R, kW>;
  }
  template <typename T, int kW>
  static auto bwd() {
    if constexpr (std::is_same<T, float>::value)
      return smalls_bwd_kernel<T>;
    else
      return smalls_bwd_kernel_tc<kW>;
  }
};

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  mask may be NULL (every key attended).  R: the forward's
// blocks own 16 R query rows (1, 2 or 4).  dq_acc is a float32
// [B * H, S, D] scratch of the float32 backward (its contents do not
// matter); the bfloat16 backward takes none (NULL will do).
#define SMALLS_ENTRIES(TAG, T)                                               \
  int smalls_fwd_##TAG(const void* q, const void* k, const void* v,          \
                       const void* mask, void* out, void* lse, int B, int H, \
                       int S, int D, int Dv, float scale, int causal,        \
                       int R, void* stream) {                                \
    return launch_fwd<SmallsKernels, T>(q, k, v, mask, out, lse, B, H, S, D, \
                                        Dv, scale, causal, R, stream);       \
  }                                                                          \
  int smalls_bwd_##TAG(const void* q, const void* k, const void* v,          \
                       const void* mask, const void* dout, const void* lse,  \
                       const void* delta, void* dq_acc, void* dq, void* dk,  \
                       void* dv, int B, int H, int S, int D, int Dv,         \
                       float scale, int causal, void* stream) {              \
    return launch_bwd<SmallsKernels, T>(q, k, v, mask, dout, lse, delta,     \
                                        dq_acc, dq, dk, dv, B, H, S, D, Dv,  \
                                        scale, causal, stream);              \
  }

SMALLS_ENTRIES(f32, float)
SMALLS_ENTRIES(bf16, __nv_bfloat16)

#undef SMALLS_ENTRIES

// shared-memory bytes of the forward with 16 R query rows a block, of the
// float32 body (bf16 = 0) or the bfloat16 one (1), for the wrapper's
// dispatch rule
long smalls_fwd_smem_bytes(int bf16, int R, int S, int D, int Dv) {
  return (long)(bf16 ? fwd_smem_of<__nv_bfloat16>(R, S, D, Dv)
                     : fwd_smem_of<float>(R, S, D, Dv));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
