// The bfloat16 attention backward on the tensor cores: the device bodies
// of a dQ block and of a dK/dV block, shared by the flash kernels
// (flash_attention.cu: flash_dq_kernel_tc, flash_dkdv_kernel_tc, on
// [B,H,S,D] with Sq and Sk) and the single-pass backward
// (single_pass_attention.cuh: single_pass_bwd_tc, on [B,H,S,D] or
// [B,S,H,D] with Sq == Sk, both block roles in one launch).
//
// What they compute, for q [.., Sq, D], k [.., Sk, D], v [.., Sk, Dv], dO
// [.., Sq, Dv] (bfloat16), the forward's (m, log l) kept apart, delta =
// rowsum(dO * out) (both float32, computed by the caller), an optional
// key mask [B,Sk] in float32 (1 = attend) and a causal flag:
//   s   = (q . k) * scale + (1 - mask) * NEG_INF + (col > row ? NEG_INF : 0)
//   p   = exp((s - m) - log l),  dS = p * (dO . v - delta) * scale
//   dQ  = T(dS) . k,  dK = T(dS)^T . q,  dV = T(p)^T . dO     (in bf16)
// with T(x) the rounding to bfloat16 before a product (the reference's
// ds.astype(k.dtype), p.astype(do.dtype)): bf16 operands, float32 sums.
//
// Layout.  A block works on one (b, h) pair; the rows of every tensor it
// reads or writes lie in one of two orders, a template flag (PairRows):
// [B,H,S,.] (kBshd false: row s of pair bh = b H + h is row bh S + s) or
// [B,S,H,.] (true: row (b S + s) H + h).  Only the addresses differ: a
// pair's rows lie 1 or H rows apart, and the arithmetic and its order are
// the same in both.
//
// Design.  No atomics: every output element is summed by one thread in a
// fixed order, whatever the launch order.  A block is 4 warps, each
// owning 16 rows of the block's 64 (queries in dQ, keys in dK/dV) with
// the operands of those rows as A fragments in registers for the whole
// pass; it walks the other side's 64-row tiles in a loop.  The streamed
// tiles stay bf16 in shared memory (rows of the head width rounded up to
// 16, + 8 bf16 so that the 8 row addresses of an ldmatrix fall in
// distinct banks), in two slots that cp.async fills with the next tile
// while the current one is multiplied (16-byte copies where the rows
// start on 16 bytes, element copies else), with the tile's per-row floats
// beside them; one barrier a tile.  Every product is mma.sync m16n8k16
// with bf16 operands and float32 sums, 16 columns of the streamed tile at
// a time.  A thread holds rows g and g + 8 of its warp's 16 in the C
// layout; the 4 lanes t of a quad share a row.
//   dq_block_tc (64 query rows): S = q . k^T and dP = dO . v^T for 16 keys
//     (k and v by ldmatrix, as B fragments) land in float32 C fragments;
//     p and dS are formed there and T(dS) packed straight into the A
//     fragment of one k16 step (the C layout of two neighbouring n8
//     tiles); dQ += T(dS) . k takes k's B fragments by ldmatrix.trans.
//     No shared-memory round trip.
//   dkdv_block_tc (64 keys): S^T = k . q^T and dP^T = v . dO^T for 16
//     queries (the query tile's m, log l and delta beside it in shared
//     memory), then dV += T(p^T) . dO and dK += T(dS^T) . q from the
//     packed fragments, dO and q by ldmatrix.trans.
// Both keep expf as the plain versions take it, the causal tile skip and
// its all-masked vote (a row whose max is below -5e8 has seen only masked
// keys; there the causal -1e9 entries tie with the masked ones and count,
// as in the plain version.  The dQ block walks every key tile if one of
// its rows did; the dK/dV block votes once, over every query row before
// its key tile, and walks from query tile 0 if one did: the extra tiles
// add exact zeros for every other row), and the ragged tails (a key past
// Sk scores -inf, a query past Sq has p = 0 in dK/dV and is never
// written).  Head widths up to kW (64 or 128: the registers kept for
// fragments and sums).  No wgmma / TMA yet.

#pragma once

#include "attention_tiles.cuh"

namespace {

// Row 0 of pair bh (= b H + h) of a sequence of S rows and the rows
// between its row s and s + 1: row s of the pair is first + s * step, in
// any tensor of the layout.
template <bool kBshd>
struct PairRows {
  long first, step;
  __device__ PairRows(long bh, int H, int S)
      : first(kBshd ? (bh / H) * S * H + bh % H : bh * S),
        step(kBshd ? H : 1) {}
  __device__ long operator()(int s) const { return first + s * step; }
};

constexpr int kTcWarps = 4;                  // warps of a block, 16 rows each
constexpr int kTcThreads = 32 * kTcWarps;
// blocks an SM should hold at once: bounds a thread's registers to
// 65536 / (128 * blocks).  The bodies are paced by latency and want
// resident warps: on an H100 at D = 64, the flash dQ kernel at 3 blocks
// (no spill) ran 12% slower than at 4 (a 28-byte spill), its dK/dV
// kernel at 2 and at 4 blocks (spilling) 25% and up to 15% slower than at
// 3 (PERF.md §6)
__host__ __device__ constexpr int dq_min_blocks(int kW) {
  return kW == 64 ? 4 : 2;
}
__host__ __device__ constexpr int dkdv_min_blocks(int kW) {
  return kW == 64 ? 3 : 1;
}

// bf16 tile row stride: the wider head rounded up to 16, + 8
__host__ __device__ inline int tc_ld(int D, int Dv) {
  return round16(D > Dv ? D : Dv) + 8;
}

// two slots, each of two bf16 tiles [64][tc_ld] and up to 3 floats a row
size_t smem_tc(int D, int Dv) {
  return sizeof(__nv_bfloat16) * 2 * 2 * (size_t)kTile * tc_ld(D, Dv) +
         sizeof(float) * 2 * 3 * kTile;
}

// dQ of query tile qt (64 rows) of pair bh; smem holds smem_tc(D, Dv)
// bytes, aligned to 16
template <int kW, bool kBshd>
__device__ __forceinline__ void dq_block_tc(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk, int D, int Dv,
    float scale, int causal, long bh, int qt) {
  const int ld = tc_ld(D, Dv);
  const int dpad = round16(D), vpad = round16(Dv);
  const int nks = dpad / 16, nvs = vpad / 16;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* mring = reinterpret_cast<float*>(ring + 4 * kTile * ld);  // [2][64]
  auto kslot = [&](int i) { return ring + (i & 1) * 2 * kTile * ld; };
  auto vslot = [&](int i) { return kslot(i) + kTile * ld; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column pair
  const int q0 = qt * kTile;
  const PairRows<kBshd> qrows(bh, H, Sq), krows(bh, H, Sk);
  const float* kmask = mask ? mask + (bh / H) * Sk : nullptr;
  const __nv_bfloat16* qb = q + qrows.first * D;
  const __nv_bfloat16* kb = k + krows.first * D;
  const __nv_bfloat16* vb = v + krows.first * Dv;
  const __nv_bfloat16* ob = dout + qrows.first * Dv;
  const long qstr = qrows.step * D, kstr = krows.step * D;  // row strides
  const long vstr = krows.step * Dv, ostr = qrows.step * Dv;
  // D % 8 == 0 makes every row stride (step D) a multiple of 8 too
  const bool vec_d = D % 8 == 0 && aligned16(qb) && aligned16(kb);
  const bool vec_v = Dv % 8 == 0 && aligned16(vb) && aligned16(ob);

  // k, v and the raw key mask of key tile kt into slot kt
  auto load_kv = [&](int kt) {
    const int k0 = kt * kTile;
    load_tile_bf16<kTcThreads>(kslot(kt), ld, kb, kstr, k0, Sk, D, dpad,
                               kTile, vec_d);
    load_tile_bf16<kTcThreads>(vslot(kt), ld, vb, vstr, k0, Sk, Dv, vpad,
                               kTile, vec_v);
    if (kmask && threadIdx.x < kTile) {
      const int c = k0 + threadIdx.x;
      cp_async_small<4>(mring + (kt & 1) * kTile + threadIdx.x,
                        c < Sk ? kmask + c : kmask, c < Sk ? 4 : 0);
    }
    cp_async_commit();
  };

  // this thread's rows 16 warp + g + 8 h: m, log l, delta
  float rm[2], rl[2], rd[2];
  bool all_masked = false;  // a real row of the tile saw only masked keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + 16 * warp + g + 8 * h;
    const long row = qrows(qr);
    rm[h] = qr < Sq ? lse[row * 2] : 0.f;
    rl[h] = qr < Sq ? lse[row * 2 + 1] : 0.f;
    rd[h] = qr < Sq ? delta[row] : 0.f;
    all_masked |= qr < Sq && rm[h] < kAllMasked;
  }
  const int nk = (Sk + kTile - 1) / kTile;
  const int nlive = causal ? min(nk, (q0 + kTile - 1) / kTile + 1) : nk;
  const int kend = __syncthreads_or(all_masked) ? nk : nlive;

  // the query and dO tiles through slot 1, into registers as A fragments
  load_tile_bf16<kTcThreads>(kslot(1), ld, qb, qstr, q0, Sq, D, dpad, kTile,
                             vec_d);
  load_tile_bf16<kTcThreads>(vslot(1), ld, ob, ostr, q0, Sq, Dv, vpad, kTile,
                             vec_v);
  load_kv(0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kW / 16][4], of[kW / 16][4];
  const int frow = (16 * warp + lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks) {
    if (ks < nks) ldmatrix_x4(qf[ks], kslot(1) + frow + 16 * ks);
    if (ks < nvs) ldmatrix_x4(of[ks], vslot(1) + frow + 16 * ks);
  }
  __syncthreads();  // slot 1 is free

  // B fragments of 16 streamed rows (n) by d: ldmatrix of rows n0 + ...,
  // and of 16 streamed rows (k) by 16 output columns: ldmatrix.trans
  const int brow = ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  const int trow = (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
  float acc[kW / 8][4] = {};
  for (int kt = 0; kt < kend; ++kt) {
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
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {  // 16 keys at a time
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int d = 0; d < kW / 16; ++d) {
        uint32_t bf[4];
        if (d < nks) {
          ldmatrix_x4(bf, Kt + 16 * ks * ld + brow + 16 * d);
          mma_bf16(s[0], qf[d], bf[0], bf[1]);
          mma_bf16(s[1], qf[d], bf[2], bf[3]);
        }
        if (d < nvs) {
          ldmatrix_x4(bf, Vt + 16 * ks * ld + brow + 16 * d);
          mma_bf16(dp[0], of[d], bf[0], bf[1]);
          mma_bf16(dp[1], of[d], bf[2], bf[3]);
        }
      }
      uint32_t a[4];  // T(dS) of 16 rows x these 16 keys, an A fragment
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = 16 * ks + 8 * j + 2 * t;  // columns cl, cl + 1
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
          float d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][2 * h + e] * scale + bias[e];
            if (causal && k0 + cl + e > qr) x += kNegInf;
            const float p = expf((x - rm[h]) - rl[h]);
            d2[e] = p * (dp[j][2 * h + e] - rd[h]) * scale;
          }
          a[2 * j + h] = pack_bf16(d2[0], d2[1]);
        }
      }
#pragma unroll
      for (int n = 0; n < kW / 16; ++n) {
        if (n < nks) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, Kt + 16 * ks * ld + trow + 16 * n);
          mma_bf16(acc[2 * n], a, bf[0], bf[1]);
          mma_bf16(acc[2 * n + 1], a, bf[2], bf[3]);
        }
      }
    }
  }

  const bool vec_out = D % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(dq) & 3) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + 16 * warp + g + 8 * h;
    if (qr >= Sq) continue;
    __nv_bfloat16* drow = dq + qrows(qr) * D;
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float o0 = acc[n][2 * h], o1 = acc[n][2 * h + 1];
      if (vec_out && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(drow + c) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        if (c < D) drow[c] = __float2bfloat16(o0);
        if (c + 1 < D) drow[c + 1] = __float2bfloat16(o1);
      }
    }
  }
}

// dK and dV of key tile kt (64 keys) of pair bh; smem as dq_block_tc's
template <int kW, bool kBshd>
__device__ __forceinline__ void dkdv_block_tc(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const float* __restrict__ mask, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
    int Sq, int Sk, int D, int Dv, float scale, int causal, long bh,
    int kt) {
  const int ld = tc_ld(D, Dv);
  const int dpad = round16(D), vpad = round16(Dv);
  const int nks = dpad / 16, nvs = vpad / 16;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* lring = reinterpret_cast<float*>(ring + 4 * kTile * ld);  // [2][64][2]
  float* dring = lring + 2 * 2 * kTile;                             // [2][64]
  auto qslot = [&](int i) { return ring + (i & 1) * 2 * kTile * ld; };
  auto oslot = [&](int i) { return qslot(i) + kTile * ld; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = kt * kTile;
  const PairRows<kBshd> qrows(bh, H, Sq), krows(bh, H, Sk);
  const __nv_bfloat16* qb = q + qrows.first * D;
  const __nv_bfloat16* kb = k + krows.first * D;
  const __nv_bfloat16* vb = v + krows.first * Dv;
  const __nv_bfloat16* ob = dout + qrows.first * Dv;
  const float* lb = lse + qrows.first * 2;
  const float* db = delta + qrows.first;
  const long qstr = qrows.step * D, kstr = krows.step * D;  // row strides
  const long vstr = krows.step * Dv, ostr = qrows.step * Dv;
  const long rs = qrows.step;            // rows between two queries
  // D % 8 == 0 makes every row stride (step D) a multiple of 8 too
  const bool vec_d = D % 8 == 0 && aligned16(qb) && aligned16(kb);
  const bool vec_v = Dv % 8 == 0 && aligned16(vb) && aligned16(ob);
  const bool vec_l = (reinterpret_cast<uintptr_t>(lb) & 7) == 0;

  // q, dO and the rows' m, log l, delta of query tile qt into slot i
  auto load_q = [&](int i, int qt) {
    const int q0 = qt * kTile;
    load_tile_bf16<kTcThreads>(qslot(i), ld, qb, qstr, q0, Sq, D, dpad, kTile,
                               vec_d);
    load_tile_bf16<kTcThreads>(oslot(i), ld, ob, ostr, q0, Sq, Dv, vpad,
                               kTile, vec_v);
    if (threadIdx.x < kTile) {
      const int r = threadIdx.x, qc = q0 + r;
      const bool live = qc < Sq;
      float* lr = lring + ((i & 1) * kTile + r) * 2;
      if (vec_l) {
        cp_async_small<8>(lr, live ? lb + qc * rs * 2 : lb, live ? 8 : 0);
      } else {
        lr[0] = live ? lb[qc * rs * 2] : 0.f;
        lr[1] = live ? lb[qc * rs * 2 + 1] : 0.f;
      }
      cp_async_small<4>(dring + (i & 1) * kTile + r, live ? db + qc * rs : db,
                        live ? 4 : 0);
    }
    cp_async_commit();
  };

  // this thread's key rows k0 + 16 warp + g + 8 h: their additive bias
  // (-inf past Sk)
  float kbias[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + 16 * warp + g + 8 * h;
    kbias[h] = kr >= Sk ? -INFINITY
                        : (mask ? (1.f - mask[(bh / H) * Sk + kr]) * kNegInf
                                : 0.f);
  }
  // causal: query tiles wholly before this key tile see none of it,
  // unless one of their rows saw only masked keys (the vote)
  const int nq = (Sq + kTile - 1) / kTile;
  int qstart = 0;
  if (causal) {
    bool need = false;
    const int before = min(k0, Sq);
    for (int r = threadIdx.x; r < before; r += kTcThreads)
      need |= lb[r * rs * 2] < kAllMasked;
    qstart = __syncthreads_or(need) ? 0 : min(k0 / kTile, nq);
  }

  // the key and value tiles through slot 1, into registers as A
  // fragments
  load_tile_bf16<kTcThreads>(qslot(1), ld, kb, kstr, k0, Sk, D, dpad, kTile,
                             vec_d);
  load_tile_bf16<kTcThreads>(oslot(1), ld, vb, vstr, k0, Sk, Dv, vpad, kTile,
                             vec_v);
  if (qstart < nq) load_q(0, qstart);
  else cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[kW / 16][4], vf[kW / 16][4];
  const int frow = (16 * warp + lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < kW / 16; ++ks) {
    if (ks < nks) ldmatrix_x4(kf[ks], qslot(1) + frow + 16 * ks);
    if (ks < nvs) ldmatrix_x4(vf[ks], oslot(1) + frow + 16 * ks);
  }
  __syncthreads();  // slot 1 is free

  const int brow = ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
  const int trow = (((lane / 8) % 2) * 8 + lane % 8) * ld + (lane / 16) * 8;
  float adk[kW / 8][4] = {}, adv[kW / 8][4] = {};
  for (int i = 0; qstart + i < nq; ++i) {
    const int qt = qstart + i, q0 = qt * kTile;
    if (i > 0) {
      cp_async_wait<0>();
      __syncthreads();  // as in dq_block_tc
    }
    if (qt + 1 < nq) load_q(i + 1, qt + 1);
    const __nv_bfloat16* Qt = qslot(i);
    const __nv_bfloat16* Ot = oslot(i);
    const float* lr = lring + (i & 1) * kTile * 2;
    const float* dr = dring + (i & 1) * kTile;
#pragma unroll
    for (int qs = 0; qs < kTile / 16; ++qs) {  // 16 queries at a time
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int d = 0; d < kW / 16; ++d) {
        uint32_t bf[4];
        if (d < nks) {
          ldmatrix_x4(bf, Qt + 16 * qs * ld + brow + 16 * d);
          mma_bf16(st[0], kf[d], bf[0], bf[1]);
          mma_bf16(st[1], kf[d], bf[2], bf[3]);
        }
        if (d < nvs) {
          ldmatrix_x4(bf, Ot + 16 * qs * ld + brow + 16 * d);
          mma_bf16(dpt[0], vf[d], bf[0], bf[1]);
          mma_bf16(dpt[1], vf[d], bf[2], bf[3]);
        }
      }
      uint32_t ap[4], as[4];  // T(p^T), T(dS^T): 16 keys x 16 queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = 16 * qs + 8 * j + 2 * t;  // query columns cl, cl + 1
        const float4 ml = *reinterpret_cast<const float4*>(lr + cl * 2);
        const float2 dl = *reinterpret_cast<const float2*>(dr + cl);
        const float qm[2] = {ml.x, ml.z}, ql[2] = {ml.y, ml.w};
        const float qd[2] = {dl.x, dl.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kr = k0 + 16 * warp + g + 8 * h;
          float p2[2], d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = q0 + cl + e;
            float x = st[j][2 * h + e] * scale + kbias[h];
            if (causal && kr > qc) x += kNegInf;
            const float p = qc < Sq ? expf((x - qm[e]) - ql[e]) : 0.f;
            p2[e] = p;
            d2[e] = p * (dpt[j][2 * h + e] - qd[e]) * scale;
          }
          ap[2 * j + h] = pack_bf16(p2[0], p2[1]);
          as[2 * j + h] = pack_bf16(d2[0], d2[1]);
        }
      }
#pragma unroll
      for (int n = 0; n < kW / 16; ++n) {
        uint32_t bf[4];
        if (n < nvs) {
          ldmatrix_x4_trans(bf, Ot + 16 * qs * ld + trow + 16 * n);
          mma_bf16(adv[2 * n], ap, bf[0], bf[1]);
          mma_bf16(adv[2 * n + 1], ap, bf[2], bf[3]);
        }
        if (n < nks) {
          ldmatrix_x4_trans(bf, Qt + 16 * qs * ld + trow + 16 * n);
          mma_bf16(adk[2 * n], as, bf[0], bf[1]);
          mma_bf16(adk[2 * n + 1], as, bf[2], bf[3]);
        }
      }
    }
  }

  const bool vec_k = D % 2 == 0 && (reinterpret_cast<uintptr_t>(dk) & 3) == 0;
  const bool vec_vo = Dv % 2 == 0 &&
                      (reinterpret_cast<uintptr_t>(dv) & 3) == 0;
  auto store = [&](__nv_bfloat16* row, int width, bool vec, int c, float o0,
                   float o1) {
    if (vec && c + 1 < width) {
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(o0, o1);
    } else {
      if (c < width) row[c] = __float2bfloat16(o0);
      if (c + 1 < width) row[c + 1] = __float2bfloat16(o1);
    }
  };
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + 16 * warp + g + 8 * h;
    if (kr >= Sk) continue;
    const long row = krows(kr);
#pragma unroll
    for (int n = 0; n < kW / 8; ++n) {
      const int c = 8 * n + 2 * t;
      store(dk + row * D, D, vec_k, c, adk[n][2 * h], adk[n][2 * h + 1]);
      store(dv + row * Dv, Dv, vec_vo, c, adv[n][2 * h], adv[n][2 * h + 1]);
    }
  }
}

}  // namespace
