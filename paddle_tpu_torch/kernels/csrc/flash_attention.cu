// Streaming (flash) attention for Hopper (sm_90a): forward, dQ and dK/dV,
// plain C interface.
//
// Replaces, in paddle_tpu/ops/attention_ops.py (the forward launched by
// _pallas_attention, the backward pair by _pallas_attention_bwd):
//   flash_fwd_kernel, flash_fwd_kernel_tc     <- _flash_fwd_kernel
//   flash_dq_kernel, flash_dq_kernel_tc       <- _flash_dq_kernel
//   flash_dkdv_kernel, flash_dkdv_kernel_tc   <- _flash_dkdv_kernel
//
// What they compute, for q [B,H,Sq,D], k [B,H,Sk,D], v [B,H,Sk,Dv] (all
// float32 or all bfloat16, contiguous), an optional key mask [B,Sk] in
// float32 (1 = attend) and a causal flag:
//   s    = (q . k) * scale + (1 - mask) * NEG_INF + (col > row ? NEG_INF : 0)
//   m    = max_j s,  l = sum_j exp(s - m),  p = exp((s - m) - log l)
//   out  = (sum_j T(exp(s - m)) v_j) / l               (in q's dtype)
//   lse  = (m, log l)  [B,H,Sq,2] float32, the two kept APART: on a fully
//          masked row m ~ -1e9 and fl(m + log l) == m in float32, which
//          would give the backward p = 1 per entry instead of 1/n
//   dS   = p * (dO . v - delta) * scale,  delta = rowsum(dO * out)
//   dQ   = T(dS) . k,  dK = T(dS)^T . q,  dV = T(p)^T . dO  (in the inputs'
//          dtype)
// with NEG_INF = -1e9, added exactly as the reference adds it, so fully
// masked rows give its uniform 1/n probabilities.  delta is computed by
// the caller (a torch reduction, as in the reference).  T(x) rounds x to
// the operand type before a product, where the reference casts
// (p.astype(v.dtype), p.astype(do.dtype), ds.astype(q.dtype),
// ds.astype(k.dtype)): products take T operands and sum in float32; l
// sums the unrounded exp(s - m).  The forward, like the reference's
// kernel, takes exp(s - m) against the running max of the key tiles so
// far and rounds it there.
//
// What bounds them on this card.  Operations: 4*Sq*Sk*D a (b, h) for the
// forward (two products), 10*Sq*Sk*D for the backward (five), about half
// under the causal mask; the bytes (each input read once, each output
// written once) are small beside that from Sq = Sk = 256 on.  The bound
// is the tensor-core rate of the inputs' type.  The split backward
// recomputes two products (q . k and dO . v in both kernels): 14 Sq Sk D
// a pair for the two, against a fused backward's 10.
//
// The body by dtype (the launchers pick the kernel; no body is tried and
// another taken on failure):
//   float32  -> the CUDA-core kernels below (flash_fwd_kernel,
//               flash_dq_kernel, flash_dkdv_kernel): float32 products,
//               as in the reference, and bit-stable (TF32 tensor cores
//               would round the operands to 10 bits);
//   bfloat16 -> all three on the tensor cores (flash_fwd_kernel_tc, see
//               "The bfloat16 forward"; flash_dq_kernel_tc and
//               flash_dkdv_kernel_tc, see "The bfloat16 backward" below).
//
// Design of the CUDA-core kernels.  The TPU kernels walk a sequential
// grid axis, carrying the online-softmax state (m, l, acc) or the dK/dV
// sums in VMEM from one grid step to the next.  GPU blocks run in
// parallel and in no order, so that axis becomes a loop inside the block:
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

#include <type_traits>

#include "attention_bwd_tc.cuh"

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
        Ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = round_to<T>(p);
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

// ---------------------------------------------------------------------------
// The bfloat16 bodies on the tensor cores.
//
// The three kernels keep the split of the reference and of the CUDA-core
// kernels (no atomics: every output element is summed by one thread in
// a fixed order, whatever the launch order), and walk the other side's
// 64-row tiles in a loop.  A block is 4 warps, each owning 16 rows of
// the block's 64 (queries in the forward and dQ, keys in dK/dV) with the
// operands of those rows as A fragments in registers for the whole pass.
// The streamed tiles stay bf16 in shared memory (rows of the head width
// rounded up to 16, + 8 bf16 so that the 8 row addresses of an ldmatrix
// fall in distinct banks), in two slots that cp.async fills with the
// next tile while the current one is multiplied (16-byte copies where
// the rows start on 16 bytes, element copies else), with the tile's
// per-row floats beside them; one barrier a tile.  Every product is
// mma.sync m16n8k16 with bf16 operands and float32 sums.  A thread holds
// rows g and g + 8 of its warp's 16 in the C layout; the 4 lanes t of a
// quad share a row, so a row's max or sum over a tile reduces over those
// 4 lanes by shuffles.
//
// The bfloat16 forward, flash_fwd_kernel_tc (a block: 64 query rows of
// one (b, h), q's A fragments in registers), streams the 64-key tiles of
// k and v with the tile's raw key mask:
//   S = q . k^T for the tile's 64 keys (k by ldmatrix as B fragments)
//   lands in eight float32 C fragments, where scale, key bias and the
//   causal -1e9 are applied.  The online softmax stays in registers:
//   the tile's row max (over the quad), m_new = max(m, it), alpha =
//   exp(m - m_new), acc *= alpha on the thread's own elements of the
//   row, p = exp(s - m_new) with l = l alpha + the row sum of the
//   unrounded p; T(p) is packed straight from two n8 C fragments into
//   the A fragment of one k16 step of acc += T(p) . v (v by
//   ldmatrix.trans).  No shared-memory round trip for p.
// out = acc / l in bf16, (m, log l) in float32, as the CUDA-core body.
// The causal tile skip and its all-masked vote are that body's, voted
// once at the first tile above the diagonal: a row whose max is below
// -5e8 there gets only causal -1e9 entries from the later tiles, so its
// max stays below and every later vote would agree.  Causal launches
// take the query tiles longest-first over all (b, h), so that short
// rows fill the tail.
//
// The bfloat16 backward, flash_dq_kernel_tc (a block: 64 query rows of
// one (b, h)) and flash_dkdv_kernel_tc (a block: 64 keys of one (b, h)),
// runs the device bodies of attention_bwd_tc.cuh (dq_block_tc,
// dkdv_block_tc; the single-pass backward runs them too): S and dP for
// 16 streamed rows at a time in float32 C fragments, T(dS) and T(p)
// packed from them into A fragments, no shared-memory round trip.
// Builds for head widths up to 64 and up to 128 (kW: the registers kept
// for fragments and sums).  No wgmma / TMA yet.
// ---------------------------------------------------------------------------

// blocks of the forward an SM should hold at once (see dq_min_blocks in
// attention_bwd_tc.cuh): on an H100 at D = 64, the forward at 3 and at 5
// blocks ran 19-26% and 12% slower than at 4 (PERF.md §6)
__host__ __device__ constexpr int fwd_min_blocks(int kW) {
  return kW == 64 ? 4 : 2;
}

template <int kW>
__global__ void __launch_bounds__(kTcThreads, fwd_min_blocks(kW))
    flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int H, int Sq, int Sk,
                        int D, int Dv, float scale, int causal,
                        int nq_tiles) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ld = tc_ld(D, Dv);
  const int dpad = round16(D), vpad = round16(Dv);
  const int nks = dpad / 16, nvs = vpad / 16;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  float* mring = reinterpret_cast<float*>(ring + 4 * kTile * ld);  // [2][64]
  auto kslot = [&](int i) { return ring + (i & 1) * 2 * kTile * ld; };
  auto vslot = [&](int i) { return kslot(i) + kTile * ld; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  // causal: the longest query tiles of every (b, h) first
  const long nbh = gridDim.x / nq_tiles;
  const long bh = causal ? blockIdx.x % nbh : blockIdx.x / nq_tiles;
  const int qt = causal ? nq_tiles - 1 - (int)(blockIdx.x / nbh)
                        : (int)(blockIdx.x % nq_tiles);
  const int q0 = qt * kTile;
  const float* kmask = mask ? mask + (bh / H) * Sk : nullptr;
  const __nv_bfloat16* qb = q + bh * Sq * D;
  const __nv_bfloat16* kb = k + bh * Sk * D;
  const __nv_bfloat16* vb = v + bh * Sk * Dv;
  const bool vec_d = D % 8 == 0 && aligned16(qb) && aligned16(kb);
  const bool vec_v = Dv % 8 == 0 && aligned16(vb);

  // k, v and the raw key mask of key tile kt into slot kt
  auto load_kv = [&](int kt) {
    const int k0 = kt * kTile;
    load_tile_bf16<kTcThreads>(kslot(kt), ld, kb, D, k0, Sk, D, dpad, kTile,
                               vec_d);
    load_tile_bf16<kTcThreads>(vslot(kt), ld, vb, Dv, k0, Sk, Dv, vpad,
                               kTile, vec_v);
    if (kmask && threadIdx.x < kTile) {
      const int c = k0 + threadIdx.x;
      cp_async_small<4>(mring + (kt & 1) * kTile + threadIdx.x,
                        c < Sk ? kmask + c : kmask, c < Sk ? 4 : 0);
    }
    cp_async_commit();
  };

  // the query tile through slot 1, into registers as A fragments
  load_tile_bf16<kTcThreads>(kslot(1), ld, qb, D, q0, Sq, D, dpad, kTile,
                             vec_d);
  load_kv(0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kW / 16][4];
  const int frow = (16 * warp + lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks)
    if (ks < nks) ldmatrix_x4(qf[ks], kslot(1) + frow + 16 * ks);
  __syncthreads();  // slot 1 is free

  // B fragments of 16 keys (n) by d: ldmatrix of rows n0 + ..., and of
  // 16 keys (k) by 16 output columns: ldmatrix.trans
  const int brow = ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  const int trow = (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
  // this thread's rows 16 warp + g + 8 h: running max, sum, accumulators
  float m[2] = {kMInit, kMInit}, l[2] = {0.f, 0.f};
  float acc[kW / 8][4] = {};
  const int nk = (Sk + kTile - 1) / kTile;
  int kend = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt == kend) {  // above the diagonal: see the causal skip
      bool need = false;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        need |= q0 + 16 * warp + g + 8 * h < Sq && m[h] < kAllMasked;
      if (!__syncthreads_or(need)) break;
      kend = nk;
      load_kv(kt);  // its slot's last tile, kt - 2, is done with
    }
    if (kt > 0) {
      cp_async_wait<0>();
      // tile kt is in for every thread, and every thread is done with
      // tile kt - 1, whose slot takes tile kt + 1 now
      __syncthreads();
    }
    if (kt + 1 < kend) load_kv(kt + 1);
    const __nv_bfloat16* Kt = kslot(kt);
    const __nv_bfloat16* Vt = vslot(kt);
    const float* mk = mring + (kt & 1) * kTile;
    const int k0 = kt * kTile;
    // only tiles that reach past the block's first row hold causal -1e9s
    const bool diag = causal && k0 + kTile - 1 > q0;

    float s[kTile / 8][4] = {};  // n8 tile n: keys 8 n + 2 t, + 1
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int d = 0; d < kW / 16; ++d) {
        if (d < nks) {
          uint32_t bf[4];
          ldmatrix_x4(bf, Kt + 16 * ks * ld + brow + 16 * d);
          mma_bf16(s[2 * ks], qf[d], bf[0], bf[1]);
          mma_bf16(s[2 * ks + 1], qf[d], bf[2], bf[3]);
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      const int cl = 8 * n + 2 * t;  // columns cl, cl + 1 of the tile
      float bias[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + cl + e;
        bias[e] = c >= Sk ? -INFINITY
                          : (kmask ? (1.f - mk[cl + e]) * kNegInf : 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = q0 + 16 * warp + g + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * h + e] * scale + bias[e];
          if (diag && k0 + cl + e > qr) x += kNegInf;
          s[n][2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      const float alpha = expf(m[h] - m_new);
      l[h] *= alpha;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < kW / 8; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {  // 16 keys at a time
      uint32_t a[4];  // T(p) of 16 rows x these 16 keys, an A fragment
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = expf(s[2 * ks + j][2 * h] - m[h]);
          const float p1 = expf(s[2 * ks + j][2 * h + 1] - m[h]);
          ps[h] += p0;
          ps[h] += p1;
          a[2 * j + h] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int n = 0; n < kW / 16; ++n) {
        if (n < nvs) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Vt + 16 * ks * ld + trow + 16 * n);
          mma_bf16(acc[2 * n], a, bf[0], bf[1]);
          mma_bf16(acc[2 * n + 1], a, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l[h] += ps[h];
    }
  }

  const bool vec_out = Dv % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + 16 * warp + g + 8 * h;
    if (qr >= Sq) continue;
    const long row = bh * Sq + qr;
    __nv_bfloat16* orow = out + row * Dv;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float o0 = acc[n][2 * h] / l[h], o1 = acc[n][2 * h + 1] / l[h];
      if (vec_out && c + 1 < Dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        if (c < Dv) orow[c] = __float2bfloat16(o0);
        if (c + 1 < Dv) orow[c + 1] = __float2bfloat16(o1);
      }
    }
    if (t == 0) {
      lse[row * 2] = m[h];
      lse[row * 2 + 1] = logf(l[h]);
    }
  }
}

template <int kW>
__global__ void __launch_bounds__(kTcThreads, dq_min_blocks(kW))
    flash_dq_kernel_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                       int D, int Dv, float scale, int causal,
                       int nq_tiles) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  dq_block_tc<kW, false>(tc_smem, q, k, v, mask, dout, lse, delta, dq, H, Sq,
                         Sk, D, Dv, scale, causal, blockIdx.x / nq_tiles,
                         (int)(blockIdx.x % nq_tiles));
}

template <int kW>
__global__ void __launch_bounds__(kTcThreads, dkdv_min_blocks(kW))
    flash_dkdv_kernel_tc(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Sk, int D, int Dv, float scale, int causal,
                         int nk_tiles) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  dkdv_block_tc<kW, false>(tc_smem, q, k, v, mask, dout, lse, delta, dk, dv,
                           H, Sq, Sk, D, Dv, scale, causal,
                           blockIdx.x / nk_tiles,
                           (int)(blockIdx.x % nk_tiles));
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int Dv) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || Dv <= 0 ||
         D > kMaxD || Dv > kMaxD;
}

// set a kernel's dynamic shared memory, launch it on `stream` and return
// cudaGetLastError() (0 = launched)
template <typename Kernel, typename... Args>
int launch(Kernel kernel, long blocks, int threads, size_t smem,
           void* stream, Args... args) {
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

// each kernel by dtype: bfloat16 runs the tensor-core bodies (the build
// for head widths up to 64 where both fit, else up to 128), float32 the
// CUDA-core ones
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* lse, int B, int H, int Sq, int Sk, int D,
               int Dv, float scale, int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, Dv)) return (int)cudaErrorInvalidValue;
  const int nt = (Sq + kTile - 1) / kTile;
  const long blocks = (long)B * H * nt;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch(D <= 64 && Dv <= 64 ? flash_fwd_kernel_tc<64>
                                      : flash_fwd_kernel_tc<kMaxD>,
                  blocks, kTcThreads, smem_tc(D, Dv), stream, (const T*)q,
                  (const T*)k, (const T*)v, (const float*)mask, (T*)out,
                  (float*)lse, H, Sq, Sk, D, Dv, scale, causal, nt);
  } else {
    return launch(flash_fwd_kernel<T>, blocks, kThreads, fwd_smem(D, Dv),
                  stream, (const T*)q, (const T*)k, (const T*)v,
                  (const float*)mask, (T*)out, (float*)lse, H, Sq, Sk, D,
                  Dv, scale, causal, nt);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* mask,
              const void* dout, const void* lse, const void* delta, void* dq,
              int B, int H, int Sq, int Sk, int D, int Dv, float scale,
              int causal, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, Dv)) return (int)cudaErrorInvalidValue;
  const int nt = (Sq + kTile - 1) / kTile;
  const long blocks = (long)B * H * nt;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch(D <= 64 && Dv <= 64 ? flash_dq_kernel_tc<64>
                                      : flash_dq_kernel_tc<kMaxD>,
                  blocks, kTcThreads, smem_tc(D, Dv), stream,
                  (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
                  (const T*)dout, (const float*)lse, (const float*)delta,
                  (T*)dq, H, Sq, Sk, D, Dv, scale, causal, nt);
  } else {
    return launch(flash_dq_kernel<T>, blocks, kThreads, dq_smem(D, Dv),
                  stream, (const T*)q, (const T*)k, (const T*)v,
                  (const float*)mask, (const T*)dout, (const float*)lse,
                  (const float*)delta, (T*)dq, H, Sq, Sk, D, Dv, scale,
                  causal, nt);
  }
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch(D <= 64 && Dv <= 64 ? flash_dkdv_kernel_tc<64>
                                      : flash_dkdv_kernel_tc<kMaxD>,
                  blocks, kTcThreads, smem_tc(D, Dv), stream,
                  (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
                  (const T*)dout, (const float*)lse, (const float*)delta,
                  (T*)dk, (T*)dv, H, Sq, Sk, D, Dv, scale, causal, nt);
  } else {
    return launch(flash_dkdv_kernel<T>, blocks, kThreads, dkdv_smem(D, Dv),
                  stream, (const T*)q, (const T*)k, (const T*)v,
                  (const float*)mask, (const T*)dout, (const float*)lse,
                  (const float*)delta, (T*)dk, (T*)dv, H, Sq, Sk, D, Dv,
                  scale, causal, nt);
  }
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
