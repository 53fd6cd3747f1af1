// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: _paged_decode_kernel in paddle_tpu/ops/attention_ops.py
// (launched by _pallas_paged_attention).  One query row per slot attends
// over the K/V rows [0, lens) of that slot, which live in the pages its
// page-table row lists; the result is softmax(q k^T * scale) v per head.
//
// What bounds it on this card: bytes.  Each live K/V row is read once
// (2 * lens * D * 4 bytes per slot and head) for 4 * D flops, far below
// the card's ~20 flops per byte of float32 balance.  At the serving shape
// (8 slots, 2 heads, D = 16) the whole step moves well under a megabyte,
// so latency is what the time is made of: the launch and the dependent
// loads (lens, page table, K/V rows) before the first product.
//
// Design: split-K over the cache, as flash-decoding does.  The TPU kernel
// walks the pages as a sequential grid axis and carries the online-softmax
// state in VMEM between grid steps.  Its first port here gave each
// (slot, head) one block of 4 warps that walked the rows one dependent
// chain at a time (page id, K row, a 5-step shuffle, two expf, V row):
// 16 blocks on 132 SMs at the serving shape, nothing in flight ahead of
// the chain, half the lanes idle at D = 16.  Now the rows [0, P * PL) of
// a (slot, head) are cut into partitions of R rows (R from the wrapper,
// paged_decode_partitions); the grid is (partitions, H, S).
//   * A block first turns its partition's page ids into row indices in
//     shared memory, once.  A partition that starts at or past lens writes
//     the empty state (m = -1e30, l = 0) and returns.
//   * G lanes take one row (G a power of two, D <= G * E * VEC): with
//     D % 4 == 0 and 16-byte aligned pools each lane loads float4 pieces
//     (VEC 4; at D = 16 a warp covers 8 rows a load, at D = 128 one row),
//     else single floats (VEC 1).  A shuffle over the G lanes gives q.k.
//   * Each lane group issues the K and V loads of kTile rows before any
//     of their math, then makes one online-softmax update for the tile.
//   * The block's groups merge their (m, l, acc) through shared memory.
//     With one partition the block writes out = acc / max(l, 1e-30)
//     directly; else it writes its partial (m, l, acc[D]) to float32
//     scratch that the wrapper allocates, and paged_merge_kernel, one
//     block per (slot, head), weights the partials by exp(m_p - M) and
//     divides by the weighted l with the same 1e-30 floor.  A dead slot
//     (lens == 0) so gives a finite zero row.
// Page ids are clamped into [0, NP) as the gather of the plain version
// does, so a bad table cannot read outside the pool.  Any D <= 256 and
// any PL run: there is no D % 128 or PL % 8 gate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxRows = 1024;  // largest partition (row indices in smem)
constexpr int kTile = 4;        // rows a lane group loads before its math
constexpr float kMInit = -1e30f;

template <int VEC>
__device__ __forceinline__ void load_piece(const float* p, int piece,
                                           float* v) {
  if constexpr (VEC == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[piece];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = p[piece];
  }
}

// Partition blockIdx.x of (slot blockIdx.z, head blockIdx.y): G lanes a
// row, E pieces of VEC values a lane.
template <int VEC, int G, int E>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,           // [S, H*D]
                    const float* __restrict__ kc,          // [NP, PL, H*D]
                    const float* __restrict__ vc,          // [NP, PL, H*D]
                    const int32_t* __restrict__ page_table,  // [S, P]
                    const int32_t* __restrict__ lens,        // [S]
                    float* __restrict__ out,                 // [S, H*D]
                    float* __restrict__ part,  // [3 parts] m, l, acc
                    int P, int NP, int PL, int H, int D, int R,
                    float scale) {
  constexpr int kGroups = kThreads / G;  // lane groups of the block
  constexpr int kWidth = G * E * VEC;    // a group's accumulator (>= D)
  const int part_i = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int nparts = gridDim.x;
  const int tid = threadIdx.x;
  const int grp = tid / G;
  const int gl = tid % G;
  const int HD = H * D;
  const int n = max(0, min(lens[s], P * PL));
  const int t0 = part_i * R;
  const int rows = min(R, n - t0);
  const size_t nstates = (size_t)gridDim.z * H * nparts;
  const size_t state = ((size_t)s * H + h) * nparts + part_i;
  float* orow = out + (size_t)s * HD + (size_t)h * D;
  if (rows <= 0) {
    if (nparts > 1) {
      if (tid == 0) {
        part[state] = kMInit;
        part[nstates + state] = 0.f;
      }
    } else {
      for (int d = tid; d < D; d += kThreads) orow[d] = 0.f;
    }
    return;
  }

  __shared__ int row_index[kMaxRows];
  const int32_t* pt = page_table + (size_t)s * P;
  for (int j = tid; j < rows; j += kThreads) {
    const int t = t0 + j;
    const int page = min(max((int)pt[t / PL], 0), NP - 1);
    row_index[j] = page * PL + t % PL;
  }

  const int pieces = D / VEC;  // VEC is 4 only when D % 4 == 0
  const float* qs = q + (size_t)s * HD + (size_t)h * D;
  float qv[E][VEC], acc[E][VEC];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int pc = gl + G * e;
#pragma unroll
    for (int c = 0; c < VEC; ++c) qv[e][c] = acc[e][c] = 0.f;
    if (pc < pieces) load_piece<VEC>(qs, pc, qv[e]);
  }
  float m = kMInit, l = 0.f;
  __syncthreads();

  for (int base = 0; base < rows; base += kGroups * kTile) {
    float kv[kTile][E][VEC], vv[kTile][E][VEC];
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int j = base + u * kGroups + grp;
      const size_t off = j < rows
          ? (size_t)row_index[j] * HD + (size_t)h * D : 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int pc = gl + G * e;
#pragma unroll
        for (int c = 0; c < VEC; ++c) kv[u][e][c] = vv[u][e][c] = 0.f;
        if (j < rows && pc < pieces) {
          load_piece<VEC>(kc + off, pc, kv[u][e]);
          load_piece<VEC>(vc + off, pc, vv[u][e]);
        }
      }
    }
    float sc[kTile];
    float mt = m;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < VEC; ++c) dot += qv[e][c] * kv[u][e][c];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const bool live = base + u * kGroups + grp < rows;
      sc[u] = live ? dot * scale : -INFINITY;
      mt = fmaxf(mt, sc[u]);
    }
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[e][c] *= alpha;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const bool live = base + u * kGroups + grp < rows;
      const float p = live ? expf(sc[u] - mt) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[e][c] += p * vv[u][e][c];
    }
    m = mt;
  }

  // merge the block's lane groups
  __shared__ float sm_m[kGroups], sm_l[kGroups], sm_w[kGroups];
  __shared__ float sm_acc[kGroups][kWidth];
  if (gl == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int c = 0; c < VEC; ++c) sm_acc[grp][(gl + G * e) * VEC + c] =
        acc[e][c];
  __syncthreads();
  float mx = kMInit;
  for (int g = 0; g < kGroups; ++g) mx = fmaxf(mx, sm_m[g]);
  if (tid < kGroups) sm_w[tid] = expf(sm_m[tid] - mx);
  __syncthreads();
  float denom = 0.f;
  for (int g = 0; g < kGroups; ++g) denom += sm_l[g] * sm_w[g];
  float* pacc = nparts > 1 ? part + 2 * nstates + state * D : nullptr;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int g = 0; g < kGroups; ++g) a += sm_acc[g][d] * sm_w[g];
    if (nparts == 1)
      orow[d] = a / fmaxf(denom, 1e-30f);
    else
      pacc[d] = a;
  }
  if (nparts > 1 && tid == 0) {
    part[state] = mx;
    part[nstates + state] = denom;
  }
}

// One block per (head blockIdx.x, slot blockIdx.y): out = sum_p w_p acc_p
// / max(sum_p w_p l_p, 1e-30) with w_p = exp(m_p - max_p m_p), over the
// partitions that saw a row (l_p > 0; an empty one wrote no acc).
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int S, int H, int D, int nparts) {
  const int h = blockIdx.x, s = blockIdx.y;
  const size_t nstates = (size_t)S * H * nparts;
  const size_t first = ((size_t)s * H + h) * nparts;
  const float* pm = part + first;
  const float* pl = part + nstates + first;
  const float* pa = part + 2 * nstates + first * D;
  float mx = kMInit;
  for (int p = 0; p < nparts; ++p) mx = fmaxf(mx, pm[p]);
  float denom = 0.f;
  for (int p = 0; p < nparts; ++p)
    if (pl[p] > 0.f) denom += pl[p] * expf(pm[p] - mx);
  float* orow = out + (size_t)s * H * D + (size_t)h * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int p = 0; p < nparts; ++p)
      if (pl[p] > 0.f) a += expf(pm[p] - mx) * pa[(size_t)p * D + d];
    orow[d] = a / fmaxf(denom, 1e-30f);
  }
}

struct Args {
  const float *q, *kc, *vc;
  const int32_t *pt, *lens;
  float *out, *part;
  int P, NP, PL, H, D, R;
  float scale;
};

template <int VEC, int G, int E>
void launch_split(dim3 grid, const Args& a, cudaStream_t stream) {
  paged_decode_kernel<VEC, G, E><<<grid, kThreads, 0, stream>>>(
      a.q, a.kc, a.vc, a.pt, a.lens, a.out, a.part, a.P, a.NP, a.PL, a.H,
      a.D, a.R, a.scale);
}

// G = g, a power of two up to 32, with one piece a lane
template <int VEC, int G = 1>
void launch_one_piece(int g, dim3 grid, const Args& a, cudaStream_t stream) {
  if (g > G) {
    if constexpr (G < 32) launch_one_piece<VEC, 2 * G>(g, grid, a, stream);
    return;
  }
  launch_split<VEC, G, 1>(grid, a, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// rows [0, P * PL) of a (slot, head) are cut into ceil(P * PL /
// rows_per_part) partitions; with more than one, `scratch` holds
// S * H * partitions * (D + 2) floats and a merge kernel follows.
int paged_decode_f32(const void* q, const void* kc, const void* vc,
                     const void* page_table, const void* lens, void* out,
                     void* scratch, int S, int P, int NP, int PL, int H,
                     int D, int rows_per_part, float scale, void* stream) {
  if (S <= 0 || H <= 0) return 0;
  if (D <= 0 || D > kMaxD || P <= 0 || NP <= 0 || PL <= 0 ||
      rows_per_part <= 0 || rows_per_part > kMaxRows || S > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const long nparts = ((long)P * PL + rows_per_part - 1) / rows_per_part;
  if (nparts > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool aligned = (((uintptr_t)q | (uintptr_t)kc | (uintptr_t)vc) &
                        15) == 0;
  const int vec = D % 4 == 0 && aligned ? 4 : 1;
  const int pieces = D / vec;
  int e = 1;  // pieces a lane
  while (e * 32 < pieces) e *= 2;
  int g = 1;  // lanes a row
  while (g * e < pieces) g *= 2;
  const Args a{(const float*)q, (const float*)kc, (const float*)vc,
               (const int32_t*)page_table, (const int32_t*)lens,
               (float*)out, (float*)scratch, P, NP, PL, H, D, rows_per_part,
               scale};
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)nparts, (unsigned)H, (unsigned)S);
  if (vec == 4) {
    if (e == 1) launch_one_piece<4>(g, grid, a, st);
    else launch_split<4, 32, 2>(grid, a, st);
  } else {
    if (e == 1) launch_one_piece<1>(g, grid, a, st);
    else if (e == 2) launch_split<1, 32, 2>(grid, a, st);
    else if (e == 4) launch_split<1, 32, 4>(grid, a, st);
    else launch_split<1, 32, 8>(grid, a, st);
  }
  if (nparts > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    paged_merge_kernel<<<dim3((unsigned)H, (unsigned)S), kThreads, 0, st>>>(
        (const float*)scratch, (float*)out, S, H, D, (int)nparts);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
