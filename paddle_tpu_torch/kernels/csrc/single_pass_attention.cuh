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
// Replaces (TPU kernels, file:line of the Pallas body):
//   forward:  _smalls_fwd_kernel  paddle_tpu/ops/attention_ops.py:309 and
//             exp_smalls_attn.py:48 (smalls_attention.cu),
//             _bshd_fwd_kernel    exp_bshd_attn.py:42 (bshd_attention.cu);
//   backward: _smalls_bwd_kernel  attention_ops.py:327, exp_smalls_attn.py:74,
//             _bshd_bwd_kernel    exp_bshd_attn.py:69.
//
// What bounds them on this card.  Operations: 4 S^2 D a (b, h) pair for
// the forward (two products), 10 S^2 D for the backward (five), about
// half under the causal mask.  At the S these kernels take (route C's
// 512, the [B,S,H,D] flagship's 256, D = 64) the bytes bound the forward
// and the causal backward: each input read and each output written once
// takes longer at 3.35 TB/s than the products at the bf16 tensor-core
// peak; route C's key-masked backward is bound by its products (PERF.md's
// kernel table).  Neither bound is near: latency (a block's chain of tile
// loads, products and barriers) and what a block re-reads (its pair's
// other side, from L2) decide the time.
//
// The body by dtype (each source's K::fwd<T, R, kW> and K::bwd<T, kW>
// pick the kernel, and the launchers its grid, threads and shared memory;
// no body is tried and another taken on failure):
//   float32  -> the CUDA-core bodies below (single_pass_fwd,
//               single_pass_bwd): float32 products, as in the reference,
//               and bit-stable (TF32 tensor cores would round the
//               operands to 10 bits);
//   bfloat16 -> both on the tensor cores (single_pass_fwd_tc,
//               single_pass_bwd_tc).
//
// Design.  The TPU kernels hold a pair's whole [S, S] score tile in VMEM
// (and the [B,S,H,D] one all H heads of a batch row at once).  A block
// here has 227 KB of shared memory (one pair's float32 scores are 1 MB at
// S = 512) and the card wants many blocks, so what is kept of the idea is
// "one pass, no online softmax, no running state": a forward block owns a
// tile of 16 R query rows of one pair (R = 4, 2 or 1, the caller's choice,
// 2 where it fits) and holds their scores against ALL S keys in shared
// memory; key tiles of 64 stream through once for q . k, each row's max
// and sum are taken over the finished row, and the v tiles stream through
// once for T(e) . v.
//   bfloat16 forward (4 R warps): warp w owns the 16 query rows w % R of
//     the block, its q fragments in registers (ldmatrix from a bf16 tile)
//     for the whole pass, and of the 4 warps of those rows, slice w / R:
//     16 keys of each 64-key tile for q . k, 16-column pairs of the
//     output for T(e) . v.  q, k and v stay bf16 in shared memory
//     (rows of the head width rounded up to 16, + 8 bf16 so the 8 row
//     addresses of an ldmatrix fall in distinct banks), k and v in two
//     slots that cp.async fills with the next tile while the current one
//     is multiplied (16-byte copies where the rows start on 16 bytes,
//     element copies else).  Both products are mma.sync m16n8k16, bf16
//     operands and float32 sums: q . k from ldmatrix fragments of k, its
//     scaled, biased float32 scores stored into the rows' score buffer
//     (a row stride of the padded keys + 8, so a fragment's 8-byte
//     accesses meet no bank twice) while each thread keeps the maxima of
//     its two rows; the slices' maxima meet in shared memory, a warp a
//     row turns the finished row into e = exp(s - m), sums l from the
//     float32 e and leaves T(e) in its place; T(e) . v reads its A
//     fragments straight from the score rows and v through
//     ldmatrix.trans, sums in float32 registers, divides by l at the
//     store.  One barrier a key or v tile.  What paces it is latency (a
//     block's chain of tile loads, products and barriers), so it is
//     built for resident warps: 4 warps for 16 rows, a build for head
//     widths up to 64 (fewer registers for q fragments and sums) and
//     one up to 128, and launch bounds that hold a block of 32 rows at
//     64 registers (4 blocks an SM where shared memory allows).  No
//     wgmma / TMA yet.
//   float32 forward (256 threads as 16 x 16): tiles widened to float32
//     rows of D + 1, both products as fmaf micro-tiles (tile_dot,
//     tile_mul of attention_tiles.cuh), synchronous tile loads.
//   bfloat16 backward (one launch, two block roles, no atomics and no
//     scratch): the grid holds a key block and a query block for each
//     (pair, 64-row tile), 2 B H ceil(S / 64) blocks of 4 warps.  A key
//     block owns 64 keys (16 a warp, k and v A fragments in registers),
//     streams its pair's query tiles (q, dO, and each row's m, log l and
//     delta) through two cp.async slots and sums dV += T(p^T) . dO and
//     dK += T(dS^T) . q; a query block owns 64 query rows, streams the k
//     and v tiles and sums dQ += T(dS) . k.  These are the flash
//     backward's tensor-core bodies (dkdv_block_tc, dq_block_tc of
//     attention_bwd_tc.cuh) with the pair's rows in this layout: each
//     output element is summed by one thread in a fixed order, so the
//     result does not depend on the launch order.  The query blocks
//     recompute S and dP: 14 D operations a (query, key) pair for the
//     function's 10 D.  The grid runs the key blocks first, then the
//     query blocks (with the two roles interleaved, a pair's key and
//     query block of one rank side by side, the kernel ran 25-37% slower
//     on an H100: PERF.md §6), and under the causal mask each run takes
//     the longest walks first over all pairs (rank r: the key tile r,
//     which walks the S / 64 - r query tiles from the diagonal down, and
//     the query tile S / 64 - 1 - r, which walks as many key tiles), so
//     that short blocks fill the tail.  One launch keeps the kernel one
//     counted call.
//   float32 backward: one block per pair, so that dK and dV (sums over
//     all queries) and dQ (a sum over all keys) need no atomics and the
//     result does not depend on the launch order.  Key tiles outside,
//     query tiles inside: the key tile's dK and dV stay in registers; the
//     query tile's dQ is summed over the key tiles in a float32 scratch in
//     device memory ([B H, S, D] in either layout, allocated by the
//     caller) of which a block touches only its pair's slice, each element
//     always by the same thread, and the last key tile writes dQ in T.
// All keep the flash kernels' causal tile skip: tiles above the diagonal
// are skipped, unless a row of the tile has seen nothing but masked keys
// (its max below -5e8), where the causal -1e9 entries tie with the
// masked ones and count, as in the plain version; the block votes
// (__syncthreads_or) to walk on.  For every other row a skipped entry is
// exp(<= -5e8) == 0 exactly.  Ragged S is masked inside (a key past S
// scores -inf, a query past S is computed and never written): any S the
// forward's shared memory holds, D, Dv <= 128.

#pragma once

#include <type_traits>

#include "attention_bwd_tc.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// the bfloat16 forward on the tensor cores
// ---------------------------------------------------------------------------

// warps of a row group (16 query rows): the key and output-column slices
constexpr int kTcSlices = 4;
// threads of a forward block of 16 R query rows: 4 warps a row group
__host__ __device__ constexpr int tc_threads(int R) {
  return 32 * kTcSlices * R;
}
// blocks of 16 R query rows (head widths up to kW) an SM should hold at
// once, which bounds a thread's registers to 65536 / (threads * blocks):
// latency, not issue or bandwidth, paces the body, so it wants resident
// warps.  R = 2 at kW = 64 fits 64 registers with no spill (4 blocks, 32
// warps an SM where shared memory allows, as at S = 256); at kW = 128 it
// spills there, and takes 3.
__host__ __device__ constexpr int tc_min_blocks(int R, int kW) {
  return R == 1 ? 4 : R == 2 ? (kW == 64 ? 4 : 3) : 1;
}

// score row stride of the tensor-core body: the padded keys + 8 floats,
// so that the 8-byte accesses of a fragment (4 rows x 4 lanes of a half
// warp) fall in 32 distinct banks
__host__ __device__ inline int score_ld_tc(int S) {
  return (S + kTile - 1) / kTile * kTile + 8;
}

size_t fwd_smem_tc(int R, int S, int D, int Dv) {
  const int w = round16(D > Dv ? D : Dv);
  return sizeof(float) * (size_t)16 * R * score_ld_tc(S) +
         sizeof(__nv_bfloat16) * 2 * (size_t)kTile * (w + 8) +
         sizeof(float) * (size_t)(kTcSlices + 2) * 16 * R;
}

// The bfloat16 forward (see the note at the top).  4 R warps; warp w owns
// row group w % R (16 query rows, its Q fragments in registers) and slice
// w / R of the 4 warps of that group: 16 keys of every key tile in pass
// 1, 16-column pairs sl and sl + 4 of the output in pass 3.  kW (64 or
// 128) bounds D and Dv: the registers kept for q fragments and sums.
template <int R, int kW, bool kBshd>
__device__ __forceinline__ void single_pass_fwd_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H, int S,
    int D, int Dv, float scale, int causal, int nq_tiles) {
  constexpr int kRows = 16 * R;            // query rows of a block
  constexpr int C = kTcSlices;             // warps of a row group
  constexpr int kWarps = C * R;
  constexpr int kThr = tc_threads(R);
  constexpr int kColPairs = kW / 16 / C;   // 16-column pairs a warp may own
  extern __shared__ __align__(16) float tc_smem[];
  const int ldS = score_ld_tc(S);
  const int nk = (S + kTile - 1) / kTile;
  const int dpad = round16(D), vpad = round16(Dv);
  const int ldt = round16(D > Dv ? D : Dv) + 8;  // bf16 tile row stride
  float* Sc = tc_smem;                            // [kRows][ldS] scores
  __nv_bfloat16* ring =                           // [2][64][ldt] tiles
      reinterpret_cast<__nv_bfloat16*>(Sc + kRows * ldS);
  float* red = reinterpret_cast<float*>(ring + 2 * kTile * ldt);  // [C][kRows]
  float* mrow = red + C * kRows;                  // [kRows] row max
  float* lrow = mrow + kRows;                     // [kRows] row sum

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % R, sl = warp / R;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const long bh = blockIdx.x / nq_tiles;
  const int q0 = (int)(blockIdx.x % nq_tiles) * kRows;
  const PairRows<kBshd> rows(bh, H, S);
  const float* kmask = mask ? mask + (bh / H) * S : nullptr;
  const __nv_bfloat16* qb = q + rows.first * D;
  const __nv_bfloat16* kb = k + rows.first * D;
  const __nv_bfloat16* vb = v + rows.first * Dv;
  const long qks = rows.step * D, vst = rows.step * Dv;
  const bool vec_qk = D % 8 == 0 && qks % 8 == 0 && aligned16(qb) &&
                      aligned16(kb);
  const bool vec_v = Dv % 8 == 0 && vst % 8 == 0 && aligned16(vb);
  auto slot = [&](int i) { return ring + (i & 1) * kTile * ldt; };

  // the query tile through slot 1, into registers as A fragments
  load_tile_bf16<kThr>(slot(1), ldt, qb, qks, q0, S, D, dpad, kRows, vec_qk);
  load_tile_bf16<kThr>(slot(0), ldt, kb, qks, 0, S, D, dpad, kTile, vec_qk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int nks = dpad / 16;
  uint32_t qf[kW / 16][4];
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks)
    if (ks < nks)
      ldmatrix_x4(qf[ks], slot(1) + (16 * rg + lane % 16) * ldt + 16 * ks +
                              (lane / 16) * 8);
  __syncthreads();  // slot 1 is free

  // this thread's partial maxima of its rows g and g + 8 (over its
  // columns), published per slice into red
  float mx[2] = {-INFINITY, -INFINITY};
  auto publish_max = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) red[sl * kRows + 16 * rg + g + 8 * h] = mx[h];
    }
  };
  auto row_max_of = [&](int r) {
    float m = red[r];
#pragma unroll
    for (int c = 1; c < C; ++c) m = fmaxf(m, red[c * kRows + r]);
    return m;
  };

  // pass 1: s = q . k for every key tile, into shared memory
  const int nlive = causal ? min(nk, (q0 + kRows - 1) / kTile + 1) : nk;
  int kend = nlive;  // key tiles that take part
  bool prefetched = true;  // tile kt's load was issued (tile 0: above)
  for (int kt = 0; kt < nk; ++kt) {
    if (kt == nlive) {  // above the diagonal from here: see the causal skip
      publish_max();
      __syncthreads();
      bool need = false;
      if (threadIdx.x < kRows)
        need = row_max_of(threadIdx.x) < kAllMasked &&
               q0 + (int)threadIdx.x < S;
      if (!__syncthreads_or(need)) break;
      kend = nk;
    }
    if (!prefetched) {  // the first tile past the vote
      load_tile_bf16<kThr>(slot(kt), ldt, kb, qks, kt * kTile, S, D, dpad,
                           kTile, vec_qk);
      cp_async_commit();
    }
    cp_async_wait<0>();
    // one barrier a tile: tile kt is in for every thread, and every
    // thread is done with tile kt - 1, whose slot takes tile kt + 1 now
    __syncthreads();
    prefetched = kt + 1 < kend;
    if (prefetched) {  // the next tile lands while this one is scored
      load_tile_bf16<kThr>(slot(kt + 1), ldt, kb, qks, (kt + 1) * kTile, S,
                           D, dpad, kTile, vec_qk);
      cp_async_commit();
    }

    const __nv_bfloat16* Kt = slot(kt);
    const int n0 = 16 * sl;               // this warp's 16 keys of the tile
    const int c0 = kt * kTile + n0 + 2 * t;
    float bias[2][2];                     // columns c0 + 8 j + e
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        bias[j][e] = c >= S ? -INFINITY
                            : (kmask ? (1.f - kmask[c]) * kNegInf : 0.f);
      }
    float acc[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < kW / 16; ++ks) {
      if (ks < nks) {
        uint32_t bf[4];
        ldmatrix_x4(bf, Kt + (n0 + (lane / 16) * 8 + lane % 8) * ldt +
                            16 * ks + ((lane / 8) % 2) * 8);
        mma_bf16(acc[0], qf[ks], bf[0], bf[1]);
        mma_bf16(acc[1], qf[ks], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + 8 * j;           // columns c, c + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * rg + g + 8 * h;  // block row
        const int qr = q0 + r;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = acc[j][2 * h + e] * scale + bias[j][e];
          if (causal && c + e > qr) x[e] += kNegInf;
        }
        *reinterpret_cast<float2*>(Sc + r * ldS + c) =
            make_float2(x[0], x[1]);
        mx[h] = fmaxf(mx[h], fmaxf(x[0], x[1]));
      }
    }
  }

  // the first v tile lands during pass 2, in the slot that the last key
  // tile but one used (v tile j in slot kend + j)
  load_tile_bf16<kThr>(slot(kend), ldt, vb, vst, 0, S, Dv, vpad, kTile,
                       vec_v);
  cp_async_commit();

  // pass 2: each row's max (from the slices' maxima) and sum over the
  // finished row; T(e) is left in place of the scores, as float32
  publish_max();
  __syncthreads();
  const int kcols = kend * kTile;
  for (int r = warp; r < kRows; r += kWarps) {
    const float m = row_max_of(r);
    float* row = Sc + r * ldS;
    float sum = 0.f;
    for (int c = 2 * lane; c < kcols; c += 64) {
      const float2 x = *reinterpret_cast<const float2*>(row + c);
      const float e0 = expf(x.x - m), e1 = expf(x.y - m);
      sum += e0;
      sum += e1;
      *reinterpret_cast<float2*>(row + c) =
          make_float2(round_to<__nv_bfloat16>(e0),
                      round_to<__nv_bfloat16>(e1));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      mrow[r] = m;
      lrow[r] = sum;
    }
  }

  // pass 3: out = T(e) . v / l; T(e) read from the score rows as A
  // fragments, v through ldmatrix.trans as B fragments
  float oacc[kColPairs][2][4] = {};
  const int vpairs = vpad / 16;
  for (int kt = 0; kt < kend; ++kt) {
    cp_async_wait<0>();
    // v tile kt is in for every thread, every thread is done with tile
    // kt - 1 (first tile: T(e) and l are complete)
    __syncthreads();
    if (kt + 1 < kend) {
      load_tile_bf16<kThr>(slot(kend + kt + 1), ldt, vb, vst,
                           (kt + 1) * kTile, S, Dv, vpad, kTile, vec_v);
      cp_async_commit();
    }
    const __nv_bfloat16* Vt = slot(kend + kt);
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      const float* p0 =
          Sc + (16 * rg + g) * ldS + kt * kTile + 16 * ks + 2 * t;
      const float* p1 = p0 + 8 * ldS;
      uint32_t a[4];
      float2 x = *reinterpret_cast<const float2*>(p0);
      a[0] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(p1);
      a[1] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(p0 + 8);
      a[2] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(p1 + 8);
      a[3] = pack_bf16(x.x, x.y);
#pragma unroll
      for (int pi = 0; pi < kColPairs; ++pi) {
        const int cp = sl + pi * C;  // 16-column pair of the output
        if (cp < vpairs) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Vt + (16 * ks + ((lane / 8) % 2) * 8 +
                                      lane % 8) * ldt +
                                    16 * cp + (lane / 16) * 8);
          mma_bf16(oacc[pi][0], a, bf[0], bf[1]);
          mma_bf16(oacc[pi][1], a, bf[2], bf[3]);
        }
      }
    }
  }

  const bool vec_out = Dv % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rg + g + 8 * h;
    const int qr = q0 + r;
    if (qr >= S) continue;
    const float l = lrow[r];
    __nv_bfloat16* orow = out + rows(qr) * Dv;
#pragma unroll
    for (int pi = 0; pi < kColPairs; ++pi) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * (sl + pi * C) + 8 * j + 2 * t;
        const float o0 = oacc[pi][j][2 * h] / l;
        const float o1 = oacc[pi][j][2 * h + 1] / l;
        if (vec_out && c + 1 < Dv) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(o0, o1);
        } else {
          if (c < Dv) orow[c] = __float2bfloat16(o0);
          if (c + 1 < Dv) orow[c + 1] = __float2bfloat16(o1);
        }
      }
    }
  }
  for (int r = threadIdx.x; r < kRows; r += kThr) {
    const int qr = q0 + r;
    if (qr >= S) continue;
    const long row = rows(qr);
    lse[row * 2] = mrow[r];
    lse[row * 2 + 1] = logf(lrow[r]);
  }
}

// shared memory of the forward body of a dtype: float32 runs the
// CUDA-core body, bfloat16 the tensor-core one (see the note at the top)
template <typename T>
size_t fwd_smem_of(int R, int S, int D, int Dv) {
  return std::is_same<T, float>::value ? fwd_smem(R, S, D, Dv)
                                       : fwd_smem_tc(R, S, D, Dv);
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

// The bfloat16 backward (see the note at the top): of the 2 B H nt
// blocks (nt = ceil(S / 64)), block j < B H nt is the key block of
// (pair, rank) j, block B H nt + j its query block.  Without the causal
// mask a pair's ranks lie together; with it the ranks run over all
// pairs, longest walks first.
template <int kW, bool kBshd>
__device__ __forceinline__ void single_pass_bwd_tc(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int S, int D, int Dv, float scale, int causal, int nt) {
  extern __shared__ __align__(16) unsigned char bwd_tc_smem[];
  const long nbh = gridDim.x / (2 * nt);
  const long half = gridDim.x / 2;
  const bool key_block = blockIdx.x < half;
  const long j = key_block ? blockIdx.x : blockIdx.x - half;
  const long bh = causal ? j % nbh : j / nt;
  const int rank = (int)(causal ? j / nbh : j % nt);
  if (key_block)
    dkdv_block_tc<kW, kBshd>(bwd_tc_smem, q, k, v, mask, dout, lse, delta,
                             dk, dv, H, S, S, D, Dv, scale, causal, bh,
                             rank);
  else
    dq_block_tc<kW, kBshd>(bwd_tc_smem, q, k, v, mask, dout, lse, delta, dq,
                           H, S, S, D, Dv, scale, causal, bh, nt - 1 - rank);
}

// ---------------------------------------------------------------------------
// launchers.  K names a source's kernels: K::fwd<T, R, kW>() (of the type
// below) and K::bwd<T, kW>() return its __global__ functions.
// ---------------------------------------------------------------------------

template <typename T>
using fwd_kernel_t = void (*)(const T*, const T*, const T*, const float*,
                              T*, float*, int, int, int, int, float, int,
                              int);

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on sm_90

bool bad_shape(int B, int H, int S, int D, int Dv) {
  return B <= 0 || H <= 0 || S <= 0 || D <= 0 || Dv <= 0 || D > kMaxD ||
         Dv > kMaxD;
}

template <class K, typename T, int R, int kW>
int launch_fwd_rows(const void* q, const void* k, const void* v,
                    const void* mask, void* out, void* lse, int B, int H,
                    int S, int D, int Dv, float scale, int causal,
                    void* stream) {
  const fwd_kernel_t<T> kernel = K::template fwd<T, R, kW>();
  const int nt = (S + 16 * R - 1) / (16 * R);
  const long blocks = (long)B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_of<T>(R, S, D, Dv);
  const int threads = std::is_same<T, float>::value ? kThreads
                                                     : tc_threads(R);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)mask, (T*)out,
      (float*)lse, H, S, D, Dv, scale, causal, nt);
  return (int)cudaGetLastError();
}

// R (16 R query rows a block) is the caller's choice: it weighs rows a
// block (reuse of a key tile) against blocks an SM (see smalls_fwd_rows in
// kernels/smalls_attention.py).  The bfloat16 body is built for head
// widths up to 64 and up to 128 (kW); the float32 body has one build.
template <class K, typename T, int R>
int launch_fwd_width(const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* lse, int B, int H,
                     int S, int D, int Dv, float scale, int causal,
                     void* stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (D <= 64 && Dv <= 64)
      return launch_fwd_rows<K, T, R, 64>(q, k, v, mask, out, lse, B, H, S,
                                          D, Dv, scale, causal, stream);
  }
  return launch_fwd_rows<K, T, R, kMaxD>(q, k, v, mask, out, lse, B, H, S,
                                         D, Dv, scale, causal, stream);
}

template <class K, typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask,
               void* out, void* lse, int B, int H, int S, int D, int Dv,
               float scale, int causal, int R, void* stream) {
  if (bad_shape(B, H, S, D, Dv) || (R != 1 && R != 2 && R != 4) ||
      fwd_smem_of<T>(R, S, D, Dv) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (R == 4)
    return launch_fwd_width<K, T, 4>(q, k, v, mask, out, lse, B, H, S, D,
                                     Dv, scale, causal, stream);
  if (R == 2)
    return launch_fwd_width<K, T, 2>(q, k, v, mask, out, lse, B, H, S, D,
                                     Dv, scale, causal, stream);
  return launch_fwd_width<K, T, 1>(q, k, v, mask, out, lse, B, H, S, D, Dv,
                                   scale, causal, stream);
}

// the backward of a dtype, kW the bfloat16 body's head-width build (the
// float32 body has one): float32 a block of 256 threads per pair with the
// float32 dQ scratch, bfloat16 the key and query blocks of 4 warps
template <class K, typename T, int kW>
int launch_bwd_width(const void* q, const void* k, const void* v,
                     const void* mask, const void* dout, const void* lse,
                     const void* delta, void* dq_acc, void* dq, void* dk,
                     void* dv, int B, int H, int S, int D, int Dv,
                     float scale, int causal, void* stream) {
  const auto kernel = K::template bwd<T, kW>();
  const int nt = (S + kTile - 1) / kTile;
  constexpr bool f32 = std::is_same<T, float>::value;
  const long blocks = f32 ? (long)B * H : 2L * B * H * nt;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = f32 ? bwd_smem(D, Dv) : smem_tc(D, Dv);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (f32) {
    kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta,
        (float*)dq_acc, (T*)dq, (T*)dk, (T*)dv, H, S, D, Dv, scale, causal);
  } else {
    kernel<<<(unsigned)blocks, kTcThreads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const float*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq,
        (T*)dk, (T*)dv, H, S, D, Dv, scale, causal, nt);
  }
  return (int)cudaGetLastError();
}

// dq_acc: the float32 body's [B H, S, D] dQ scratch (its contents do not
// matter); the bfloat16 body takes none (NULL will do)
template <class K, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta,
               void* dq_acc, void* dq, void* dk, void* dv, int B, int H,
               int S, int D, int Dv, float scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D, Dv)) return (int)cudaErrorInvalidValue;
  if constexpr (!std::is_same<T, float>::value) {
    if (D <= 64 && Dv <= 64)
      return launch_bwd_width<K, T, 64>(q, k, v, mask, dout, lse, delta,
                                        dq_acc, dq, dk, dv, B, H, S, D, Dv,
                                        scale, causal, stream);
  }
  return launch_bwd_width<K, T, kMaxD>(q, k, v, mask, dout, lse, delta,
                                       dq_acc, dq, dk, dv, B, H, S, D, Dv,
                                       scale, causal, stream);
}

}  // namespace
