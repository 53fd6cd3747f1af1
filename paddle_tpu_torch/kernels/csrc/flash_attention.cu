// Streaming (flash) attention for Hopper (sm_90a): forward, dQ and dK/dV,
// plain C interface.
//
// Replaces, in paddle_tpu/ops/attention_ops.py:
//   flash_fwd_kernel   <- _flash_fwd_kernel   (launched by _pallas_attention)
//   flash_dq_kernel    <- _flash_dq_kernel    (launched by _pallas_attention_bwd)
//   flash_dkdv_kernel  <- _flash_dkdv_kernel  (launched by _pallas_attention_bwd)
//
// What they compute, for q [B,H,Sq,D], k [B,H,Sk,D], v [B,H,Sk,Dv] (all
// float32 or all bfloat16, contiguous), an optional key mask [B,Sk] in
// float32 (1 = attend) and a causal flag:
//   s    = (q . k) * scale + (1 - mask) * NEG_INF + (col > row ? NEG_INF : 0)
//   m    = max_j s,  l = sum_j exp(s - m),  p = exp((s - m) - log l)
//   out  = (sum_j exp(s - m) v_j) / l                  (in q's dtype)
//   lse  = (m, log l)  [B,H,Sq,2] float32, the two kept APART: on a fully
//          masked row m ~ -1e9 and fl(m + log l) == m in float32, which
//          would give the backward p = 1 per entry instead of 1/n
//   dS   = p * (dO . v - delta) * scale,  delta = rowsum(dO * out)
//   dQ   = dS . k,  dK = dS^T . q,  dV = p^T . dO      (in the inputs' dtype)
// with NEG_INF = -1e9, added exactly as the reference adds it, so fully
// masked rows give its uniform 1/n probabilities.  delta is computed by
// the caller (a torch reduction, as in the reference).
//
// What bounds them on this card.  Operations: 4*Sq*Sk*D a (b, h) for the
// forward (two products), 10*Sq*Sk*D for the backward (five), about half
// under the causal mask; the bytes (each input read once, each output
// written once) are small beside that from Sq = Sk = 256 on.  The bound
// is the tensor-core rate of the inputs' type.  These first kernels do
// their products on the CUDA cores in float32 (no wgmma / mma yet), so
// they sit far from that bound; making them fast is later work.
//
// Design.  The TPU kernels walk a sequential grid axis, carrying the
// online-softmax state (m, l, acc) or the dK/dV sums in VMEM from one
// grid step to the next.  GPU blocks run in parallel and in no order, so
// that axis becomes a loop inside the block:
//   forward and dQ: one block per (b, h, 64-query tile), looping over the
//     64-key tiles; dK/dV: one block per (b, h, 64-key tile), looping
//     over the 64-query tiles.
// Tiles are staged through shared memory in float32 (padded rows, no bank
// conflicts; the helpers are in attention_tiles.cuh, shared with the
// single-pass kernels).  256 threads form a 16 x 16 grid: thread (ty, tx) owns the
// rows ty + 16 i (i < 4) of the tile and the columns tx + 16 j of the
// score tile (j < 4) and of the output (j < 8, so D <= 128).  Row
// statistics are reduced across the 16 threads of a row with warp
// shuffles, so m, l and the accumulators never leave registers.  Causal
// tiles entirely above the diagonal are skipped (the reference's causal
// block skip), unless a row of the tile has seen nothing but masked keys
// (its max below -5e8): there the causal -1e9 entries tie with the masked
// ones and count, as they do in the plain version, so the block votes
// (__syncthreads_or) to walk on.  For every other row a skipped entry
// would add exp(<= -5e8) == 0 exactly, so the skip changes no bit.
// Ragged tails are masked inside: a key past Sk scores -inf
// (probability exactly 0) and a query past Sq is computed but never
// written, so there is no tiling gate: any Sq, Sk and D, Dv <= 128.

#include "attention_tiles.cuh"

namespace {

constexpr float kMInit = -1e30f;

size_t fwd_smem(int D, int Dv) {
  return sizeof(float) * ((size_t)kTile * (D + 1) * 2 +
                          (size_t)kTile * (Dv + 1) +
                          (size_t)kTile * (kTile + 1) + kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int H,
                     int Sq, int Sk, int D, int Dv, float scale, int causal,
                     int nq_tiles) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [64][D + 1]
  float* Ks = Qs + kTile * (D + 1);       // [64][D + 1]
  float* Vs = Ks + kTile * (D + 1);       // [64][Dv + 1]
  float* Ps = Vs + kTile * (Dv + 1);      // [64][65]
  float* Kb = Ps + kTile * (kTile + 1);   // [64] key bias

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long bh = blockIdx.x / nq_tiles;
  const int q0 = (int)(blockIdx.x % nq_tiles) * kTile;
  const int b = (int)(bh / H);
  const float* mrow = mask ? mask + (long)b * Sk : nullptr;

  load_tile(Qs, q + bh * Sq * D, q0, Sq, D);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMInit;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) acc[i][jd] = 0.f;
  }

  const int nk = (Sk + kTile - 1) / kTile;
  const int nlive = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (kt >= nlive) {  // above the diagonal: see the causal skip
      bool need = false;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        need |= q0 + ty + 16 * i < Sq && m[i] < kAllMasked;
      if (!__syncthreads_or(need)) break;
    }
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_tile(Ks, k + bh * Sk * D, k0, Sk, D);
    load_tile(Vs, v + bh * Sk * Dv, k0, Sk, Dv);
    load_key_bias(Kb, mrow, k0, Sk);
    __syncthreads();

    float s[4][4] = {};
    tile_dot(s, Qs, Ks, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * scale + Kb[c];
        if (causal && k0 + c > qr) x += kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
    tile_mul(acc, Ps, kTile + 1, Vs, Dv, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Sq) continue;
    const long row = bh * Sq + qr;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int c = tx + 16 * jd;
      if (c < Dv) store_f(out, row * Dv + c, acc[i][jd] / l[i]);
    }
    if (tx == 0) {
      lse[row * 2] = m[i];
      lse[row * 2 + 1] = logf(l[i]);
    }
  }
}

size_t dq_smem(int D, int Dv) {
  return sizeof(float) * ((size_t)kTile * (D + 1) * 2 +
                          (size_t)kTile * (Dv + 1) * 2 +
                          (size_t)kTile * (kTile + 1) + kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Sq, int Sk, int D, int Dv, float scale,
                    int causal, int nq_tiles) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [64][D + 1]
  float* Ks = Qs + kTile * (D + 1);       // [64][D + 1]
  float* dOs = Ks + kTile * (D + 1);      // [64][Dv + 1]
  float* Vs = dOs + kTile * (Dv + 1);     // [64][Dv + 1]
  float* Ss = Vs + kTile * (Dv + 1);      // [64][65] dS
  float* Kb = Ss + kTile * (kTile + 1);   // [64]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long bh = blockIdx.x / nq_tiles;
  const int q0 = (int)(blockIdx.x % nq_tiles) * kTile;
  const int b = (int)(bh / H);
  const float* mrow = mask ? mask + (long)b * Sk : nullptr;

  load_tile(Qs, q + bh * Sq * D, q0, Sq, D);
  load_tile(dOs, dout + bh * Sq * Dv, q0, Sq, Dv);
  float rm[4], rl[4], rd[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    const long row = bh * Sq + qr;
    rm[i] = qr < Sq ? lse[row * 2] : 0.f;
    rl[i] = qr < Sq ? lse[row * 2 + 1] : 0.f;
    rd[i] = qr < Sq ? delta[row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) acc[i][jd] = 0.f;
  }

  const int nk = (Sk + kTile - 1) / kTile;
  const int nlive = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  bool all_masked = false;  // a real row of the tile saw only masked keys
#pragma unroll
  for (int i = 0; i < 4; ++i)
    all_masked |= q0 + ty + 16 * i < Sq && rm[i] < kAllMasked;
  const int kend = __syncthreads_or(all_masked) ? nk : nlive;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(Ks, k + bh * Sk * D, k0, Sk, D);
    load_tile(Vs, v + bh * Sk * Dv, k0, Sk, Dv);
    load_key_bias(Kb, mrow, k0, Sk);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, Qs, Ks, D, ty, tx);
    tile_dot(dp, dOs, Vs, Dv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * scale + Kb[c];
        if (causal && k0 + c > qr) x += kNegInf;
        const float p = expf((x - rm[i]) - rl[i]);
        Ss[(ty + 16 * i) * (kTile + 1) + c] = p * (dp[i][j] - rd[i]) * scale;
      }
    }
    __syncthreads();
    tile_mul(acc, Ss, kTile + 1, Ks, D, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Sq) continue;
    const long row = bh * Sq + qr;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int c = tx + 16 * jd;
      if (c < D) store_f(dq, row * D + c, acc[i][jd]);
    }
  }
}

size_t dkdv_smem(int D, int Dv) {
  return sizeof(float) * ((size_t)kTile * (D + 1) * 2 +
                          (size_t)kTile * (Dv + 1) * 2 +
                          (size_t)kTile * (kTile + 1) * 2 + 3 * kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ mask,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, int D,
                      int Dv, float scale, int causal, int nk_tiles) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // [64][D + 1]
  float* Qs = Ks + kTile * (D + 1);       // [64][D + 1]
  float* Vs = Qs + kTile * (D + 1);       // [64][Dv + 1]
  float* dOs = Vs + kTile * (Dv + 1);     // [64][Dv + 1]
  float* Ps = dOs + kTile * (Dv + 1);     // [64 keys][65 queries] p^T
  float* Ss = Ps + kTile * (kTile + 1);   // [64 keys][65 queries] dS^T
  float* Qm = Ss + kTile * (kTile + 1);   // [64] m of the query tile
  float* Ql = Qm + kTile;                 // [64] log l
  float* Qd = Ql + kTile;                 // [64] delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long bh = blockIdx.x / nk_tiles;
  const int k0 = (int)(blockIdx.x % nk_tiles) * kTile;
  const int b = (int)(bh / H);

  load_tile(Ks, k + bh * Sk * D, k0, Sk, D);
  load_tile(Vs, v + bh * Sk * Dv, k0, Sk, Dv);
  // this thread's key rows: their additive bias (-inf past Sk)
  float kb[4], adk[4][8], adv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    kb[i] = kr >= Sk ? -INFINITY
                     : (mask ? (1.f - mask[(long)b * Sk + kr]) * kNegInf
                             : 0.f);
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      adk[i][jd] = 0.f;
      adv[i][jd] = 0.f;
    }
  }

  const int nq = (Sq + kTile - 1) / kTile;
  // causal: query tiles wholly before this key tile see none of it
  const int qt0 = causal ? k0 / kTile : 0;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    bool need = false;  // a row of a skippable tile saw only masked keys
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int qc = q0 + j;
      const long row = bh * Sq + qc;
      Qm[j] = qc < Sq ? lse[row * 2] : 0.f;
      Ql[j] = qc < Sq ? lse[row * 2 + 1] : 0.f;
      Qd[j] = qc < Sq ? delta[row] : 0.f;
      need |= qc < Sq && Qm[j] < kAllMasked;
    }
    if (qt < qt0 && !__syncthreads_or(need)) continue;
    load_tile(Qs, q + bh * Sq * D, q0, Sq, D);
    load_tile(dOs, dout + bh * Sq * Dv, q0, Sq, Dv);
    __syncthreads();

    float st[4][4] = {}, dpt[4][4] = {};
    tile_dot(st, Ks, Qs, D, ty, tx);    // [key][query] scores
    tile_dot(dpt, Vs, dOs, Dv, ty, tx); // [key][query] dO . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qc = q0 + c;
        float x = st[i][j] * scale + kb[i];
        if (causal && kr > qc) x += kNegInf;
        const float p = qc < Sq ? expf((x - Qm[c]) - Ql[c]) : 0.f;
        Ps[(ty + 16 * i) * (kTile + 1) + c] = p;
        Ss[(ty + 16 * i) * (kTile + 1) + c] = p * (dpt[i][j] - Qd[c]) * scale;
      }
    }
    __syncthreads();
    tile_mul(adv, Ps, kTile + 1, dOs, Dv, ty, tx);  // dV += p^T . dO
    tile_mul(adk, Ss, kTile + 1, Qs, D, ty, tx);    // dK += dS^T . q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= Sk) continue;
    const long row = bh * Sk + kr;
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int c = tx + 16 * jd;
      if (c < D) store_f(dk, row * D + c, adk[i][jd]);
      if (c < Dv) store_f(dv, row * Dv + c, adv[i][jd]);
    }
  }
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int Dv) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || Dv <= 0 ||
         D > kMaxD || Dv > kMaxD;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* lse, int B, int H, int Sq, int Sk, int D,
               int Dv, float scale, int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, Dv)) return (int)cudaErrorInvalidValue;
  const int nt = (Sq + kTile - 1) / kTile;
  const long blocks = (long)B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (T*)out,
      (float*)lse, H, Sq, Sk, D, Dv, scale, causal, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int H, int Sq, int Sk, int D, int Dv, float scale,
              int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, Dv)) return (int)cudaErrorInvalidValue;
  const int nt = (Sq + kTile - 1) / kTile;
  const long blocks = (long)B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_kernel<T><<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, H, Sq,
      Sk, D, Dv, scale, causal, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* mask, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int B, int H, int Sq,
                int Sk, int D, int Dv, float scale, int causal,
                void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, Dv)) return (int)cudaErrorInvalidValue;
  const int nt = (Sk + kTile - 1) / kTile;
  const long blocks = (long)B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = dkdv_smem(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_dkdv_kernel<T><<<(unsigned)blocks, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, H, Sq, Sk, D, Dv, scale, causal, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).  mask may be NULL (every key attended).
#define FLASH_ENTRIES(TAG, T)                                               \
  int flash_fwd_##TAG(const void* q, const void* k, const void* v,          \
                      const void* mask, void* out, void* lse, int B, int H, \
                      int Sq, int Sk, int D, int Dv, float scale,           \
                      int causal, void* stream) {                           \
    return launch_fwd<T>(q, k, v, mask, out, lse, B, H, Sq, Sk, D, Dv,      \
                         scale, causal, stream);                            \
  }                                                                         \
  int flash_dq_##TAG(const void* q, const void* k, const void* v,           \
                     const void* mask, const void* dout, const void* lse,   \
                     const void* delta, void* dq, int B, int H, int Sq,     \
                     int Sk, int D, int Dv, float scale, int causal,        \
                     void* stream) {                                        \
    return launch_dq<T>(q, k, v, mask, dout, lse, delta, dq, B, H, Sq, Sk,  \
                        D, Dv, scale, causal, stream);                      \
  }                                                                         \
  int flash_dkdv_##TAG(const void* q, const void* k, const void* v,         \
                       const void* mask, const void* dout, const void* lse, \
                       const void* delta, void* dk, void* dv, int B, int H, \
                       int Sq, int Sk, int D, int Dv, float scale,          \
                       int causal, void* stream) {                          \
    return launch_dkdv<T>(q, k, v, mask, dout, lse, delta, dk, dv, B, H,    \
                          Sq, Sk, D, Dv, scale, causal, stream);            \
  }

FLASH_ENTRIES(f32, float)
FLASH_ENTRIES(bf16, __nv_bfloat16)

#undef FLASH_ENTRIES

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
