// Single-pass attention for Sq == Sk: the bodies of the forward kernel and
// of the ONE backward kernel for dQ, dK and dV, and their launchers, shared
// by smalls_attention.cu (q, k, v, out [B,H,S,D], residual [B,H,S,2]) and
// bshd_attention.cu ([B,S,H,D], residual [B,S,H,2]).  Each source defines
// its own __global__ kernels around these bodies (so that a profile names
// them apart) and its own C entry points.
//
// What they compute, for q, k [.., D], v [.., Dv] (all float32 or all
// bfloat16 = T, contiguous), an optional key mask [B,S] in float32
// (1 = attend) and a causal flag:
//   s    = (q . k) * scale + (1 - mask) * NEG_INF + (col > row ? NEG_INF : 0)
//   m    = max_j s,  e = exp(s - m),  l = sum_j e
//   out  = (sum_j T(e_j) v_j) / l                          (in T)
//   lse  = (m, log l) float32, kept APART (on a fully masked row
//          m ~ -1e9 and fl(m + log l) == m in float32)
//   p    = exp((s - m) - log l)
//   dV   = T(p)^T . dO,  dS = p * (dO . v - delta) * scale,
//   dQ   = T(dS) . k,    dK = T(dS)^T . q                  (in T)
// with NEG_INF = -1e9 added as the reference adds it and delta =
// rowsum(dO * out) computed by the caller.  T(x) rounds x to the operand
// type before a product, where the reference casts (p.astype(v.dtype),
// ds.astype(k.dtype)): products take T operands and sum in float32.
//
// Layout.  Every tensor the kernels read or write (q, k, v, dO, out, dQ,
// dK, dV, the residual's rows of 2 and delta's rows of 1) holds its rows
// in one of two orders, a template flag of the bodies: [B,H,S,.]
// (kBshd false: row s of pair (b, h) is row (b H + h) S + s) or [B,S,H,.]
// (true: row (b S + s) H + h, the layout of the projections' output, so
// the model needs no head transposes around the op).  Only the addresses
// differ: one pair's rows lie 1 or H rows apart; the arithmetic and its
// order are the same in both.  A row of D = 64 bf16 values is one
// 128-byte run in both, so the tile loads stay coalesced.
//
// What bounds them on this card.  Operations: 4 S^2 D a (b, h) pair for
// the forward (two products), 10 S^2 D for the backward (five), about
// half under the causal mask; the bytes (each input read once, each
// output written once) are small beside that from S = 128 on.  The bound
// is the tensor-core rate of the inputs' type.  These kernels do their
// products on the CUDA cores in float32: no wgmma / mma, no TMA, no
// cp.async pipelining of the tiles yet.
//
// Design.  The TPU kernels hold a pair's whole [S, S] score tile in VMEM
// (and the [B,S,H,D] one all H heads of a batch row at once).  A block
// here has 227 KB of shared memory (one pair's float32 scores are 1 MB at
// S = 512) and the card wants many blocks, so what is kept of the idea is
// "one pass, no online softmax, no running state":
//   forward: one block per (pair, tile of 16 R query rows; R = 4, 2 or 1
//     is the caller's choice, 2 where it fits), holding the scores of its
//     rows against ALL S keys in shared memory: key tiles of 64 stream
//     through once for q . k, each row's max and sum are taken over the
//     finished row, and the v tiles stream through once for p . v.
//   backward: one block per pair, so that dK and dV (sums over all
//     queries) and dQ (a sum over all keys) need no atomics and the
//     result does not depend on the launch order.  Key tiles outside,
//     query tiles inside: the key tile's dK and dV stay in registers; the
//     query tile's dQ is summed over the key tiles in a float32 scratch in
//     device memory ([B H, S, D] in either layout, allocated by the
//     caller) of which a block touches only its pair's slice, each element
//     always by the same thread, and the last key tile writes dQ in T.
// Both share the flash kernels' thread layout and tile helpers
// (attention_tiles.cuh) and their causal tile skip: tiles above the
// diagonal are skipped, unless a row of the tile has seen nothing but
// masked keys (its max below -5e8), where the causal -1e9 entries tie
// with the masked ones and count, as in the plain version; the block
// votes (__syncthreads_or) to walk on.  For every other row a skipped
// entry is exp(<= -5e8) == 0 exactly.  Ragged S is masked inside (a key
// past S scores -inf, a query past S is computed and never written): any
// S the forward's shared memory holds, D, Dv <= 128.

#pragma once

#include "attention_tiles.cuh"

namespace {

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

// Row 0 of pair bh (= b H + h) and the rows between its row s and s + 1:
// row s of the pair is first + s * step, in any tensor of the layout.
template <bool kBshd>
struct PairRows {
  long first, step;
  __device__ PairRows(long bh, int H, int S)
      : first(kBshd ? (bh / H) * S * H + bh % H : bh * S),
        step(kBshd ? H : 1) {}
  __device__ long operator()(int s) const { return first + s * step; }
};

// acc[i][jd] += sum_t P[t][row_i] * V[t][tx + 16 jd] over a 64-deep tile:
// tile_mul with P transposed ([64][kTile + 1], rows = t)
__device__ __forceinline__ void tile_mul_t(float (&acc)[4][8], const float* P,
                                           const float* V, int width, int ty,
                                           int tx) {
  const int ld = width + 1;
  for (int t = 0; t < kTile; ++t) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[t * (kTile + 1) + ty + 16 * i];
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) {
      const int c = tx + 16 * jd;
      if (c < width) {
        const float vv = V[t * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(p[i], vv, acc[i][jd]);
      }
    }
  }
}

// score row stride: the padded key count plus 16, so that the two rows a
// warp touches (ty, ty + 1) lie 16 banks apart
__host__ __device__ inline int score_ld(int S) {
  return (S + kTile - 1) / kTile * kTile + 16;
}

size_t fwd_smem(int R, int S, int D, int Dv) {
  const int w = D > Dv ? D : Dv;
  return sizeof(float) * ((size_t)16 * R * (D + 1) + (size_t)kTile * (w + 1) +
                          (size_t)(score_ld(S) - 16) +
                          (size_t)16 * R * score_ld(S));
}

template <typename T, int R, bool kBshd>
__device__ __forceinline__ void single_pass_fwd(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    T* __restrict__ out, float* __restrict__ lse, int H, int S, int D,
    int Dv, float scale, int causal, int nq_tiles) {
  constexpr int kRows = 16 * R;  // query rows of a block
  extern __shared__ float smem[];
  const int ldS = score_ld(S);
  const int nk = (S + kTile - 1) / kTile;
  const int w = D > Dv ? D : Dv;
  float* Qs = smem;                      // [kRows][D + 1]
  float* KVs = Qs + kRows * (D + 1);     // [64][max(D, Dv) + 1] k, then v
  float* Kb = KVs + kTile * (w + 1);     // [nk * 64] key bias
  float* Sc = Kb + nk * kTile;           // [kRows][ldS] scores, then T(e)

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long bh = blockIdx.x / nq_tiles;
  const int q0 = (int)(blockIdx.x % nq_tiles) * kRows;
  const int b = (int)(bh / H);
  const PairRows<kBshd> rows(bh, H, S);

  load_tile_strided(Qs, q + rows.first * D, rows.step * D, q0, S, D, kRows);
  load_key_bias(Kb, mask ? mask + (long)b * S : nullptr, 0, S, nk * kTile);

  float mx[R];
#pragma unroll
  for (int i = 0; i < R; ++i) mx[i] = -INFINITY;

  // pass 1: s = q . k for every key tile, into shared memory
  const int nlive = causal ? min(nk, (q0 + kRows - 1) / kTile + 1) : nk;
  int kend = nlive;  // key tiles that take part
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (kt == nlive) {  // above the diagonal from here: see the causal skip
      bool need = false;
#pragma unroll
      for (int i = 0; i < R; ++i)
        need |= row_max(mx[i]) < kAllMasked && q0 + ty + 16 * i < S;
      if (!__syncthreads_or(need)) break;
      kend = nk;
    }
    __syncthreads();  // the previous key tile is consumed (Qs, Kb loaded)
    load_tile_strided(KVs, k + rows.first * D, rows.step * D, k0, S, D);
    __syncthreads();

    float s[R][4] = {};
    tile_dot(s, Qs, KVs, D, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * scale + Kb[c];
        if (causal && c > qr) x += kNegInf;
        Sc[(ty + 16 * i) * ldS + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }

  // pass 2: each row's max and sum over the finished row; a thread reads
  // back the columns it wrote (tx + 16 n) and leaves T(e) in their place
  const int kcols = kend * kTile;
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = row_max(mx[i]);
    float* row = Sc + (ty + 16 * i) * ldS;
    float sum = 0.f;
    for (int c = tx; c < kcols; c += 16) {
      const float e = expf(row[c] - m[i]);
      sum += e;
      row[c] = round_to<T>(e);
    }
    l[i] = row_sum(sum);
  }

  // pass 3: out = T(e) . v / l
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) acc[i][jd] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();  // the previous tile is consumed; Sc is complete
    load_tile_strided(KVs, v + rows.first * Dv, rows.step * Dv, kt * kTile,
                      S, Dv);
    __syncthreads();
    tile_mul(acc, Sc + kt * kTile, ldS, KVs, Dv, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= S) continue;
    const long row = rows(qr);
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

size_t bwd_smem(int D, int Dv) {
  return sizeof(float) * ((size_t)kTile * (D + 1) * 2 +
                          (size_t)kTile * (Dv + 1) * 2 +
                          (size_t)kTile * (kTile + 1) * 2 + 3 * kTile);
}

template <typename T, bool kBshd>
__device__ __forceinline__ void single_pass_bwd(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* dq_acc, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int H, int S, int D, int Dv,
    float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                       // [64][D + 1]
  float* Qs = Ks + kTile * (D + 1);       // [64][D + 1]
  float* Vs = Qs + kTile * (D + 1);       // [64][Dv + 1]
  float* dOs = Vs + kTile * (Dv + 1);     // [64][Dv + 1]
  float* Ps = dOs + kTile * (Dv + 1);     // [64 keys][65 queries] T(p)^T
  float* Ss = Ps + kTile * (kTile + 1);   // [64 keys][65 queries] T(dS)^T
  float* Qm = Ss + kTile * (kTile + 1);   // [64] m of the query tile
  float* Ql = Qm + kTile;                 // [64] log l
  float* Qd = Ql + kTile;                 // [64] delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long bh = blockIdx.x;
  const int b = (int)(bh / H);
  const int nt = (S + kTile - 1) / kTile;  // key tiles == query tiles
  const PairRows<kBshd> rows(bh, H, S);

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous key tile's Ks / Vs are consumed
    load_tile_strided(Ks, k + rows.first * D, rows.step * D, k0, S, D);
    load_tile_strided(Vs, v + rows.first * Dv, rows.step * Dv, k0, S, Dv);
    // this thread's key rows: their additive bias (-inf past S)
    float kb[4], adk[4][8], adv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
      kb[i] = kr >= S ? -INFINITY
                      : (mask ? (1.f - mask[(long)b * S + kr]) * kNegInf
                              : 0.f);
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        adk[i][jd] = 0.f;
        adv[i][jd] = 0.f;
      }
    }

    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous query tile is consumed
      bool need = false;  // a row of the tile saw only masked keys
      for (int j = threadIdx.x; j < kTile; j += kThreads) {
        const int qc = q0 + j;
        const long row = rows(qc);
        Qm[j] = qc < S ? lse[row * 2] : 0.f;
        Ql[j] = qc < S ? lse[row * 2 + 1] : 0.f;
        Qd[j] = qc < S ? delta[row] : 0.f;
        need |= qc < S && Qm[j] < kAllMasked;
      }
      const bool all_masked = __syncthreads_or(need);
      // causal: a query tile wholly before this key tile sees none of it
      if (causal && qt < kt && !all_masked) continue;
      load_tile_strided(Qs, q + rows.first * D, rows.step * D, q0, S, D);
      load_tile_strided(dOs, dout + rows.first * Dv, rows.step * Dv, q0, S,
                        Dv);
      __syncthreads();

      float st[4][4] = {}, dpt[4][4] = {};
      tile_dot(st, Ks, Qs, D, ty, tx);     // [key][query] scores
      tile_dot(dpt, Vs, dOs, Dv, ty, tx);  // [key][query] dO . v
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qc = q0 + c;
          float x = st[i][j] * scale + kb[i];
          if (causal && kr > qc) x += kNegInf;
          const float p = qc < S ? expf((x - Qm[c]) - Ql[c]) : 0.f;
          Ps[(ty + 16 * i) * (kTile + 1) + c] = round_to<T>(p);
          Ss[(ty + 16 * i) * (kTile + 1) + c] =
              round_to<T>(p * (dpt[i][j] - Qd[c]) * scale);
        }
      }
      __syncthreads();
      tile_mul(adv, Ps, kTile + 1, dOs, Dv, ty, tx);  // dV += T(p)^T . dO
      tile_mul(adk, Ss, kTile + 1, Qs, D, ty, tx);    // dK += T(dS)^T . q

      // dQ of this query tile += T(dS) . k: summed over the key tiles in
      // the scratch (first tile: no read; last tile: written to dq in T)
      const int last_kt = causal && !all_masked ? qt : nt - 1;
      float adq[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
#pragma unroll
        for (int jd = 0; jd < 8; ++jd) {
          const int c = tx + 16 * jd;
          adq[i][jd] = kt > 0 && qr < S && c < D
                           ? dq_acc[(bh * S + qr) * D + c]
                           : 0.f;
        }
      }
      tile_mul_t(adq, Ss, Ks, D, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + ty + 16 * i;
        if (qr >= S) continue;
        const long arow = bh * S + qr;  // the scratch's row
        const long row = rows(qr);
#pragma unroll
        for (int jd = 0; jd < 8; ++jd) {
          const int c = tx + 16 * jd;
          if (c >= D) continue;
          if (kt == last_kt)
            store_f(dq, row * D + c, adq[i][jd]);
          else
            dq_acc[arow * D + c] = adq[i][jd];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty + 16 * i;
      if (kr >= S) continue;
      const long row = rows(kr);
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const int c = tx + 16 * jd;
        if (c < D) store_f(dk, row * D + c, adk[i][jd]);
        if (c < Dv) store_f(dv, row * Dv + c, adv[i][jd]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers.  K names a source's kernels: K::fwd<T, R>() and K::bwd<T>()
// return its __global__ functions, of these types.
// ---------------------------------------------------------------------------

template <typename T>
using fwd_kernel_t = void (*)(const T*, const T*, const T*, const float*,
                              T*, float*, int, int, int, int, float, int,
                              int);
template <typename T>
using bwd_kernel_t = void (*)(const T*, const T*, const T*, const float*,
                              const T*, const float*, const float*, float*,
                              T*, T*, T*, int, int, int, int, float, int);

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on sm_90

bool bad_shape(int B, int H, int S, int D, int Dv) {
  return B <= 0 || H <= 0 || S <= 0 || D <= 0 || Dv <= 0 || D > kMaxD ||
         Dv > kMaxD;
}

template <class K, typename T, int R>
int launch_fwd_rows(const void* q, const void* k, const void* v,
                    const void* mask, void* out, void* lse, int B, int H,
                    int S, int D, int Dv, float scale, int causal,
                    void* stream) {
  const fwd_kernel_t<T> kernel = K::template fwd<T, R>();
  const int nt = (S + 16 * R - 1) / (16 * R);
  const long blocks = (long)B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(R, S, D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (T*)out,
      (float*)lse, H, S, D, Dv, scale, causal, nt);
  return (int)cudaGetLastError();
}

// R (16 R query rows a block) is the caller's choice: it weighs rows a
// block (reuse of a key tile) against blocks an SM (see smalls_fwd_rows in
// kernels/smalls_attention.py)
template <class K, typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* lse, int B, int H, int S, int D, int Dv,
               float scale, int causal, int R, void* stream) {
  if (bad_shape(B, H, S, D, Dv) || (R != 1 && R != 2 && R != 4) ||
      fwd_smem(R, S, D, Dv) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (R == 4)
    return launch_fwd_rows<K, T, 4>(q, k, v, mask, out, lse, B, H, S, D, Dv,
                                    scale, causal, stream);
  if (R == 2)
    return launch_fwd_rows<K, T, 2>(q, k, v, mask, out, lse, B, H, S, D, Dv,
                                    scale, causal, stream);
  return launch_fwd_rows<K, T, 1>(q, k, v, mask, out, lse, B, H, S, D, Dv,
                                  scale, causal, stream);
}

template <class K, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta,
               void* dq_acc, void* dq, void* dk, void* dv, int B, int H,
               int S, int D, int Dv, float scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  const bwd_kernel_t<T> kernel = K::template bwd<T>();
  const long blocks = (long)B * H;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (float*)dq_acc,
      (T*)dq, (T*)dk, (T*)dv, H, S, D, Dv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace
