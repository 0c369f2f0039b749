// K1 at windows shorter than kMinWindow in bfloat16, forward and backward, on
// the tensor cores: the multi-window kernels (k1_fwd.cuh's and k1_bwd.cuh's
// launchers take them for bfloat16; float32 keeps the window tiles of
// k1_tiles.cuh).
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149) and _packed_attention_bwd (:164,
// :171), for bfloat16 inputs at W < 32.
//
// What bounds them: at the flagship's shapes (W 10, Dh 64) the function needs
// 4 * W * Dh FLOP a row forward and 10 * W * Dh backward against 8 * Dh and
// 14 * Dh bytes: 5 and 7 FLOP a byte, far under the tensor cores' ~295, so
// bytes bound it (3.1 us forward at (256, 80, 64)). But at the training shape
// the call is about one wave of blocks, and its time is one block's chain of
// phases: load, logits, softmax, products, stores. The float32 window tiles
// that ran here before widened bf16 rows into float32 tiles (twice the shared
// bytes), computed the logits and products on the float32 cores, and took the
// softmax a row a thread, 20 of 128 threads busy. These kernels shorten the
// chain: the rows are staged as they are, every product is one warp's
// mma.sync, the softmax runs on the accumulator layout with all 128 threads
// busy, and v (and dout) land while the logits are computed.
//
// A block takes G = multi_windows(W) consecutive whole windows (fewer in the
// last block), addressed through k1_tiles.cuh's Strided (Divided where a block crosses
// from one row n to the next), and
// stages the rows its strips read (multi_staged: a full block's windows' and
// up to 15 more; those past its own windows zero-filled, reading nothing) of
// q, k, v (and dout) with 16-byte
// cp.async into bf16 rows padded by 16 bytes (k1_mma.cuh's stage_mma), and
// each row's W bias entries with 4-byte cp.async into a (rows, W) float32
// tile, in two groups: q, k and the bias first, then v (and dout). Each of
// the 4 warps owns a strip of 16 query rows that starts on a window: m =
// min(4, 16 / W) whole windows up to W 16 (one at W 9-16), or one of the
// ceil(W / 16) 16-row parts of a window past it. The strip computes against
// its windows' keys laid out in chunks, a window's keys from the start of
// its own chunk(s): 8-key chunks up to W 8 (window c of the strip in chunk c;
// its products p v as m16n8k8), 16-key chunks past it (the window of W 9-16
// in one, keys 16c.. of the one window past 16 in chunk c). So key j of a
// window sits at the same place in the products whatever the block, the grid
// or the seed groups: a window's outputs are the same bits in every launch
// that holds it.
//   s = q k^T on the tensor cores (m16n8k16, bf16 operands as stored:
//     exact products, float32 sums); keys outside a row's own window, and
//     under causal those above its diagonal, are -inf and read no bias.
//   The softmax on the accumulator layout: a row's whole window is in the
//     strip's registers, so its max and sum are two quad shuffles each and
//     no rescaling is needed. Each thread draws the Philox keep bits of its
//     elements inside their windows only, in a loop of as many draws as the
//     lane with the most (the elements outside are never drawn), while the
//     copies are in flight: the bits depend on positions alone.
//   out = p_drop v on the tensor cores, p split into three bf16 parts
//     against the exact bf16 v (k1_mma.cuh's split3_bf16x2: all 24 bits of
//     p's mantissa, so out stays within one bf16 ulp of the plain version),
//     times 1 / l, rounded once as stored.
// The backward takes the same strips: s and dp = dout v^T, p, the keep bits,
// D = rowsum(dp' p) (dp' = keep * dp / keep_prob) and ds = p (dp' - D) * scale
// in registers, then dq = ds k from the strip's registers. dk and dv sum over
// a window's query rows, which past W 16 lie in several warps' strips, so
// p_drop goes through one float32 (rows, multi_tile_stride) shared tile (row a
// query, column a key's place in its window), written by the query strips
// and read back by columns: warp w then owns the keys of its strip's rows and
// their windows' queries (the same chunks), and adds dv = p_drop^T dout; then
// ds goes through the same tile for dk = ds^T q. An element outside its window
// is read as 0 (nothing wrote it). No atomics: every output is one warp's sum
// in a fixed order, so two launches are bit-equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "k1_mma.cuh"
#include "k1_tiles.cuh"
#include "philox.cuh"

namespace k1 {

constexpr int kMultiWarps = 4;
constexpr int kMultiThreads = 32 * kMultiWarps;
constexpr int kMultiRows = 16 * kMultiWarps;   // a block's rows (its windows' positions) at most
constexpr int kMultiStaged = kMultiRows + 16;  // staged rows at most: a window's last chunk
                                               // reads up to 15 rows past the block's
static_assert(kMultiThreads == kMmaThreads, "stage_mma strides by kMmaThreads");

// The layout by W < 32 (ops/attention.py mirrors each): a chunk's keys (8 up to W 8, else
// 16); chunks a window; whole windows a strip (up to W 16); 8-key tiles a strip computes
// against; windows a block; the rows a block stages (a full block's strips' chunks reach
// 16 ceil(W / 16) - 1 rows past its last window's first); the row stride of the backward's
// shared tile.
__host__ __device__ constexpr int multi_chunk(int W) { return W <= 8 ? 8 : 16; }
__host__ __device__ constexpr int multi_chunks(int W) { return W > 16 ? (W + 15) / 16 : 1; }
__host__ __device__ constexpr int multi_per_strip(int W) {
  return W > 16 ? 1 : 16 / W < 4 ? 16 / W : 4;
}
__host__ __device__ constexpr int multi_key_tiles(int W) {
  return W <= 8 ? multi_per_strip(W) : 2 * multi_chunks(W) * multi_per_strip(W);
}
__host__ __device__ constexpr int multi_windows(int W) {
  return W > 16 ? kMultiWarps / multi_chunks(W) : kMultiWarps * multi_per_strip(W);
}
__host__ __device__ constexpr int multi_staged(int W) {
  return (multi_windows(W) - 1) * W + 16 * ((W + 15) / 16);
}
__host__ __device__ constexpr int multi_tile_stride(int W) {
  return multi_chunk(W) * multi_chunks(W) + 4;
}

// Shared memory (ops/attention.py::multi_smem mirrors it): the bf16 rows, in the backward
// the float32 (kMultiRows, multi_tile_stride) tile, and the (kMultiRows, W) bias tile.
template <int DH>
constexpr int multi_fwd_smem(int W) {
  return 3 * kMultiStaged * MmaTile<__nv_bfloat16, DH>::LS * 2 + kMultiRows * W * 4;
}
template <int DH>
constexpr int multi_bwd_smem(int W) {
  return 4 * kMultiStaged * MmaTile<__nv_bfloat16, DH>::LS * 2 +
         kMultiRows * multi_tile_stride(W) * (int)sizeof(float) + kMultiRows * W * 4;
}

// Each row's W bias entries inside its window, bias[(w0 + i) * S + w0 + j], into the
// (rows, W) float32 tile bt (block row r at r * W): a thread a row, 4-byte cp.async.
__device__ __forceinline__ void stage_bias(float* bt, const float* __restrict__ bias, int rows,
                                           int W, int S, int n0) {
  const int r = threadIdx.x;
  if (r >= rows) return;
  const int lw = r / W, i = r - lw * W, nwr = S / W, n = n0 + lw, brow = n / nwr;
  const int w0 = (n - brow * nwr) * W;
  const float* src = bias + (size_t)(w0 + i) * S + w0;
  for (int j = 0; j < W; ++j) cp_async4_zfill(bt + r * W + j, src + j, true);
}

// A warp's strip: the block row of its row 0, its rows that are rows of the block's
// windows, and the block row of each chunk's first key (KC chunks).
template <int KC>
struct MultiStrip {
  int row0, nrows, kb[KC];
};

template <int KC>
__device__ __forceinline__ MultiStrip<KC> multi_strip(int warp, int W, int g) {
  MultiStrip<KC> st;
  if (W <= 16) {   // m whole windows from window warp * m, a chunk each
    const int m = multi_per_strip(W), fw = warp * m;
    const int n = min(max(g - fw, 0), m);
    st.row0 = fw * W;
    st.nrows = n * W;
#pragma unroll
    for (int c = 0; c < KC; ++c) st.kb[c] = (fw + c) * W;
  } else {         // part warp % CW of window warp / CW
    const int cw = multi_chunks(W), fw = warp / cw, part = warp - fw * cw;
    st.row0 = fw * W + 16 * part;
    st.nrows = fw < g ? max(min(16, W - 16 * part), 0) : 0;
#pragma unroll
    for (int c = 0; c < KC; ++c) st.kb[c] = fw * W + 16 * c;
  }
  return st;
}

// A thread's two rows of its strip (strip rows a = lane / 4 and a + 8: queries, and in
// the backward's second half keys): whether each is a row of the block's windows, its
// block row, its place in its window, the place of its window's key 0 among the strip's
// keys (its chunk's first), its Philox key and row and the counter of its window's key 0.
struct MultiRows {
  bool ok[2];
  int r[2], i[2], lo[2];
  unsigned seed[2], prow[2], ctr0[2];
};

template <int KC>
__device__ __forceinline__ MultiRows multi_rows(const MultiStrip<KC>& st, int lane, int W,
                                                int S, int n0, const int* __restrict__ seed_ptr,
                                                int group_rows, int dropout) {
  MultiRows m;
  const int nwr = S / W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = (lane >> 2) + 8 * h;
    m.ok[h] = a < st.nrows;
    m.r[h] = st.row0 + a;
    const int lw = m.r[h] / W;   // the row's window in the block
    m.i[h] = m.r[h] - lw * W;
    m.lo[h] = W <= 16 ? multi_chunk(W) * (a / W) : 0;
    const int n = n0 + lw, brow = n / nwr, w0 = (n - brow * nwr) * W;
    m.ctr0[h] = (unsigned)(w0 + m.i[h]) * (unsigned)S + (unsigned)w0;
    m.seed[h] = m.prow[h] = 0u;
    if (dropout && m.ok[h]) {
      const unsigned grp = (unsigned)brow / (unsigned)group_rows;
      m.seed[h] = (unsigned)__ldg(seed_ptr + grp);
      m.prow[h] = (unsigned)brow - grp * (unsigned)group_rows;
    }
  }
  return m;
}

// m16n8k8 with bf16 operands: the products of an 8-key chunk.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const unsigned (&a)[2], unsigned b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// acc += P . Z for one 8-key chunk: P the warp's (16, 8) register tile (accumulator
// layout, which is the m16n8k8 A fragment) in three bf16 parts, Z its 8 rows (row-major,
// DH's padded stride); as k1_mma.cuh's gemm_pv, the parts lo, mid, hi.
template <int DH>
__device__ __forceinline__ void pv_k8(float (&acc)[DH / 8][4], const float (&p)[4],
                                      const __nv_bfloat16* Z, int lane) {
  constexpr int LS = MmaTile<__nv_bfloat16, DH>::LS, NO = DH / 8;
  const int g = lane >> 2, t = lane & 3;
  unsigned a[2][3];
  split3_bf16x2(p[0], p[1], a[0]);   // row g, columns 2t and 2t + 1
  split3_bf16x2(p[2], p[3], a[1]);   // row g + 8
  const __nv_bfloat16* z = Z + 2 * t * LS + g;
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += kGroup) {
    unsigned b[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (n0 + u < NO) b[u] = pack_bf16(z[(n0 + u) * 8], z[LS + (n0 + u) * 8]);
#pragma unroll
    for (int part = 2; part >= 0; --part) {
      const unsigned ap[2] = {a[0][part], a[1][part]};
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NO) mma_bf16_k8(acc[n0 + u], ap, b[u]);
    }
  }
}

// acc[n] += X[0..16) . K[key of tile n]^T over DH, the keys of tile n from block row
// kb[n] (8-key chunks) or kb[n / 2] + 8 (n % 2) (16-key chunks): k1_mma.cuh's gemm_nt a
// chunk at a time.
template <int KT, int CW, int DH>
__device__ __forceinline__ void multi_nt(float (&acc)[KT][4], const __nv_bfloat16* X,
                                         const __nv_bfloat16* K,
                                         const MultiStrip<KT * 8 / CW>& st, int lane) {
  constexpr int LS = MmaTile<__nv_bfloat16, DH>::LS, TC = CW / 8;   // tiles a chunk
#pragma unroll
  for (int c = 0; c < KT / TC; ++c)
    gemm_nt<TC, DH>(*reinterpret_cast<float(*)[TC][4]>(&acc[TC * c]), X, K + st.kb[c] * LS,
                    lane);
}

// acc += P . Z over the strip's keys (queries in the backward's second half), chunk c's
// rows of Z from block row kb[c]: pv_k8 or k1_mma.cuh's gemm_pv a chunk at a time.
template <int KT, int CW, int DH>
__device__ __forceinline__ void multi_pv(float (&acc)[DH / 8][4], const float (&p)[KT][4],
                                         const __nv_bfloat16* Z,
                                         const MultiStrip<KT * 8 / CW>& st, int lane) {
  constexpr int LS = MmaTile<__nv_bfloat16, DH>::LS;
#pragma unroll
  for (int c = 0; c < KT * 8 / CW; ++c) {
    if constexpr (CW == 8)
      pv_k8<DH>(acc, p[c], Z + st.kb[c] * LS, lane);
    else
      gemm_pv<2, DH>(acc, *reinterpret_cast<const float(*)[2][4]>(&p[2 * c]),
                     Z + st.kb[c] * LS, lane);
  }
}

// The thread's elements of the strip's (16, 8 KT) tile (element (c, e): row h = e / 2,
// strip key 8c + 2t + e % 2, window place jj = that - lo[h]) inside their row's window,
// and on or below its diagonal under causal: bit 4c + e. Positions alone decide it.
template <int KT>
__device__ __forceinline__ unsigned multi_inside(const MultiRows& m, int W, int causal,
                                                 int lane) {
  const int t = lane & 3;
  unsigned inside = 0u;
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, jj = c * 8 + 2 * t + (e & 1) - m.lo[h];
      const bool in = m.ok[h] && jj >= 0 && jj < W && !(causal && jj > m.i[h]);
      inside |= (unsigned)in << (4 * c + e);
    }
  return inside;
}

// Scale and bias the strip's logits inside (the bias from the staged tile bt); -inf
// elsewhere, reading no bias there.
template <int KT>
__device__ __forceinline__ void multi_logits(float (&s)[KT][4], unsigned inside,
                                             const MultiRows& m, const float* bt, int W,
                                             float scale, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, jj = c * 8 + 2 * t + (e & 1) - m.lo[h];
      s[c][e] = (inside >> (4 * c + e)) & 1u ? s[c][e] * scale + bt[m.r[h] * W + jj]
                                             : -INFINITY;
    }
}

// The keep bits of the elements in `inside` (bit 4c + e as there), each drawn at its
// (i, j) in the packed row: each lane draws its own, lowest bit first, and the loop runs
// as many times as the lane with the most.
__device__ __forceinline__ unsigned multi_keep(const MultiRows& m, unsigned inside,
                                               unsigned thresh, int lane) {
  const int t = lane & 3;
  unsigned keep = 0u, todo = inside;
#pragma unroll 1
  while (__any_sync(0xffffffffu, todo != 0u)) {
    if (todo) {
      const int b = __ffs(todo) - 1, c = b >> 2, e = b & 3, h = e >> 1;
      todo &= todo - 1u;
      const int jj = c * 8 + 2 * t + (e & 1) - (h ? m.lo[1] : m.lo[0]);
      const unsigned ctr = (h ? m.ctr0[1] : m.ctr0[0]) + (unsigned)jj;
      if (attn_keep_bits(h ? m.seed[1] : m.seed[0], h ? m.prow[1] : m.prow[0], ctr) < thresh)
        keep |= 1u << b;
    }
  }
  return keep;
}

// The row max and 1 / sum of the strip's probabilities: s becomes exp(s - max) (0
// outside), `il` the rows' 1 / l (0 for a row past the block's windows).
template <int KT>
__device__ __forceinline__ void multi_softmax(float (&s)[KT][4], unsigned inside,
                                              const MultiRows& m, float (&il)[2]) {
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // every lane shuffles; a row past the windows has no max
    const float row_max = quad_max(mx[h]);
    mx[h] = m.ok[h] ? row_max : 0.f;
  }
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (inside >> (4 * c + e)) & 1u ? __expf(s[c][e] - mx[e >> 1]) : 0.f;
      s[c][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]);
    il[h] = m.ok[h] ? 1.f / sum : 0.f;
  }
}

// Forward: out = dropout(softmax(q k^T * scale + bias)) v, a block G whole windows; KT
// 8-key tiles a strip in chunks of CW keys.
template <int DH, int KT, int CW, bool RAGGED, bool SPAN>
__global__ void __launch_bounds__(kMultiThreads)
k1_fwd_multi(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int S, int W, int G, int nwin, float scale,
             const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
             int dropout, int causal, Head hd) {
  using Elem = __nv_bfloat16;
  constexpr int LS = MmaTile<Elem, DH>::LS, RS = kMultiStaged, KC = KT * 8 / CW;
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // RS x LS each
  Elem* ks = qs + RS * LS;
  Elem* vs = ks + RS * LS;
  float* bt = reinterpret_cast<float*>(vs + RS * LS);   // rows x W: the windows' bias

  const int n0 = blockIdx.x * G, g = min(G, nwin - n0), rows = g * W;
  // the block's rows (Divided where they cross from one row n to the next: SPAN)
  const auto rin = block_rows<SPAN>(hd, kIn, (unsigned)n0 * W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  K1_PHASE_BEGIN();
  const int staged = multi_staged(W);   // the rows the strips read, in a full block
  stage_mma<Elem, DH, RAGGED>(qs, q, rin, staged, rows, q, hd);
  stage_mma<Elem, DH, RAGGED>(ks, k, rin, staged, rows, k, hd);
  stage_bias(bt, bias, rows, W, S, n0);
  cp_async_commit();
  stage_mma<Elem, DH, RAGGED>(vs, v, rin, staged, rows, v, hd);
  cp_async_commit();
  const MultiStrip<KC> st = multi_strip<KC>(warp, W, g);
  const MultiRows m = multi_rows(st, lane, W, S, n0, seed_ptr, group_rows, dropout);
  // the mask and keep bits depend on positions alone: drawn while the copies fly
  const unsigned inside = multi_inside<KT>(m, W, causal, lane);
  const unsigned keep = dropout ? multi_keep(m, inside, thresh, lane) : 0u;
  cp_async_wait<1>();   // q, k and the bias; v may still be in flight
  __syncthreads();
  K1_PHASE(0);

  float s[KT][4] = {};
  multi_nt<KT, CW, DH>(s, qs + st.row0 * LS, ks, st, lane);
  multi_logits<KT>(s, inside, m, bt, W, scale, lane);
  float il[2];
  multi_softmax<KT>(s, inside, m, il);
  if (dropout) {
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[c][e] = (keep >> (4 * c + e)) & 1u ? s[c][e] * inv_keep : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  K1_PHASE(1);
  float o[DH / 8][4] = {};
  multi_pv<KT, CW, DH>(o, s, vs, st, lane);
  K1_PHASE(2);
  store_rows<Elem, DH, DH / 8, RAGGED>(out, block_rows<SPAN>(hd, kOut, n0 * W).from(st.row0), o,
                                       lane >> 2, st.nrows, il[0], il[1], lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

// Backward: dq, dk and dv of a block's G whole windows in one pass (file comment).
template <int DH, int KT, int CW, bool RAGGED, bool SPAN>
__global__ void __launch_bounds__(kMultiThreads)
k1_bwd_multi(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
             const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int W, int G,
             int nwin, float scale, const int* __restrict__ seed_ptr, int group_rows,
             unsigned thresh, float inv_keep, int dropout, int causal, Head hd) {
  using Elem = __nv_bfloat16;
  constexpr int LS = MmaTile<Elem, DH>::LS, RS = kMultiStaged, KC = KT * 8 / CW;
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // RS x LS each
  Elem* ks = qs + RS * LS;
  Elem* vs = ks + RS * LS;
  Elem* os = vs + RS * LS;
  const int PS = multi_tile_stride(W);
  float* pt = reinterpret_cast<float*>(os + RS * LS);   // rows x PS: p_drop, then ds
  float* bt = pt + kMultiRows * PS;                     // rows x W: the windows' bias

  const int n0 = blockIdx.x * G, g = min(G, nwin - n0), rows = g * W;
  const auto rin = block_rows<SPAN>(hd, kIn, (unsigned)n0 * W);
  const auto rout = block_rows<SPAN>(hd, kOut, (unsigned)n0 * W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  K1_PHASE_BEGIN();
  const int staged = multi_staged(W);   // the rows the strips read, in a full block
  stage_mma<Elem, DH, RAGGED>(qs, q, rin, staged, rows, q, hd);
  stage_mma<Elem, DH, RAGGED>(ks, k, rin, staged, rows, k, hd);
  stage_bias(bt, bias, rows, W, S, n0);
  cp_async_commit();
  stage_mma<Elem, DH, RAGGED>(vs, v, rin, staged, rows, v, hd);
  stage_mma<Elem, DH, RAGGED>(os, dout, rout, staged, rows, dout, hd);
  cp_async_commit();
  const MultiStrip<KC> st = multi_strip<KC>(warp, W, g);
  const MultiRows m = multi_rows(st, lane, W, S, n0, seed_ptr, group_rows, dropout);
  // the mask and keep bits depend on positions alone: drawn while the copies fly
  const unsigned inside = multi_inside<KT>(m, W, causal, lane);
  const unsigned keep = dropout ? multi_keep(m, inside, thresh, lane) : 0u;
  cp_async_wait<1>();   // q, k and the bias; v and dout may still be in flight
  __syncthreads();
  K1_PHASE(0);

  float s[KT][4] = {}, dp[KT][4] = {};
  multi_nt<KT, CW, DH>(s, qs + st.row0 * LS, ks, st, lane);
  multi_logits<KT>(s, inside, m, bt, W, scale, lane);
  float il[2];
  multi_softmax<KT>(s, inside, m, il);
  cp_async_wait<0>();
  __syncthreads();
  multi_nt<KT, CW, DH>(dp, os + st.row0 * LS, vs, st, lane);
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = s[c][e] * il[h];
      const float gd = !dropout ? dp[c][e] : (keep >> (4 * c + e)) & 1u ? dp[c][e] * inv_keep
                                                                        : 0.f;
      s[c][e] = p;
      dp[c][e] = gd;
      D[h] = fmaf(p, gd, D[h]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) D[h] = quad_sum(D[h]);
#pragma unroll
  for (int c = 0; c < KT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = s[c][e];
      dp[c][e] = p * (dp[c][e] - D[h]) * scale;   // ds: 0 outside the windows (p is)
      s[c][e] = !dropout ? p : (keep >> (4 * c + e)) & 1u ? p * inv_keep : 0.f;   // p_drop
    }
  K1_PHASE(1);
  float acc[DH / 8][4] = {};
  multi_pv<KT, CW, DH>(acc, dp, ks, st, lane);
  store_rows<Elem, DH, DH / 8, RAGGED>(dq, block_rows<SPAN>(hd, kGrad, n0 * W).from(st.row0),
                                       acc, lane >> 2, st.nrows, 1.f, 1.f, lane, hd);

  // The strip's register tile into the shared tile, at (query's block row, key's place in
  // its window), the elements inside the windows only; and back by columns: element
  // (key row h, strip query 8c + 2t + e % 2) is the tile's (query's block row, key's place)
  // where the two share a window (and, under causal, the key is not past the query), else
  // 0. A strip query's block row is its chunk's first row plus its place in the chunk.
  const auto put = [&](const float (&tile)[KT][4]) {
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, jj = c * 8 + 2 * t + (e & 1) - m.lo[h];
        if ((inside >> (4 * c + e)) & 1u) pt[m.r[h] * PS + jj] = tile[c][e];
      }
  };
  const auto columns = [&](float (&tile)[KT][4]) {
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, p = c * 8 + 2 * t + (e & 1), ii = p - m.lo[h];
        const bool in = m.ok[h] && ii >= 0 && ii < W && !(causal && m.i[h] > ii);
        tile[c][e] = in ? pt[(st.kb[p / CW] + p % CW) * PS + m.i[h]] : 0.f;
      }
  };
  put(s);
  __syncthreads();
  K1_PHASE(2);
  columns(s);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  multi_pv<KT, CW, DH>(acc, s, os, st, lane);
  store_rows<Elem, DH, DH / 8, RAGGED>(dv, block_rows<SPAN>(hd, kGrad, n0 * W).from(st.row0),
                                       acc, lane >> 2, st.nrows, 1.f, 1.f, lane, hd);
  __syncthreads();
  put(dp);
  __syncthreads();
  columns(dp);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  multi_pv<KT, CW, DH>(acc, dp, qs, st, lane);
  store_rows<Elem, DH, DH / 8, RAGGED>(dk, block_rows<SPAN>(hd, kGrad, n0 * W).from(st.row0),
                                       acc, lane >> 2, st.nrows, 1.f, 1.f, lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

// The launch plan's numbers (ops/attention.py::multi_plan): path 3, G = multi_windows(W)
// windows a block (at most the launch's), their blocks and the shared memory. The
// caller's plan must equal them.
inline bool multi_plan_ok(int W, int nwin, int path, int blocks, int smem_bytes, int smem,
                          int& G) {
  if (W < 1 || W >= 32 || nwin < 1) return false;
  G = multi_windows(W) < nwin ? multi_windows(W) : nwin;
  return path == 3 && blocks == (nwin + G - 1) / G && smem_bytes == smem;
}

// The five layouts of W < 32 (multi_key_tiles, multi_chunk): W 6-8, 5, 1-4 in 8-key
// chunks; W 9-16, 17-31 in 16-key chunks.
#define K1_MULTI_SWITCH(KERNEL, ...)                                                        \
  switch (W <= 8 ? multi_key_tiles(W) : 16 + multi_key_tiles(W)) {                          \
    case 2: return launch_multi_kernel(KERNEL<DH, 2, 8, RAGGED, SPAN>, __VA_ARGS__);        \
    case 3: return launch_multi_kernel(KERNEL<DH, 3, 8, RAGGED, SPAN>, __VA_ARGS__);        \
    case 4: return launch_multi_kernel(KERNEL<DH, 4, 8, RAGGED, SPAN>, __VA_ARGS__);        \
    case 18: return launch_multi_kernel(KERNEL<DH, 2, 16, RAGGED, SPAN>, __VA_ARGS__);      \
    case 20: return launch_multi_kernel(KERNEL<DH, 4, 16, RAGGED, SPAN>, __VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                                            \
  }

template <typename Kernel, typename... Args>
int launch_multi_kernel(Kernel kernel, int blocks, int smem, cudaStream_t stream, Args... args) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kMultiThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int DH, bool RAGGED>
int launch_multi_fwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const float* bias, __nv_bfloat16* out, int BH, int S, int W, float scale,
                     const int* seed, int group_rows, unsigned thresh, float inv_keep,
                     int dropout, int causal, int path, int blocks, int smem_bytes, Head hd,
                     cudaStream_t stream) {
  const int nwin = BH * (S / W);
  int G = 0;
  if (!multi_plan_ok(W, nwin, path, blocks, smem_bytes, multi_fwd_smem<DH>(W), G))
    return (int)cudaErrorInvalidValue;
  if (spans_rows(hd, G * W)) {
    constexpr bool SPAN = true;
    K1_MULTI_SWITCH(k1_fwd_multi, blocks, smem_bytes, stream, q, k, v, bias, out, S, W, G, nwin,
                    scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd)
  }
  constexpr bool SPAN = false;
  K1_MULTI_SWITCH(k1_fwd_multi, blocks, smem_bytes, stream, q, k, v, bias, out, S, W, G, nwin,
                  scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd)
}

template <int DH, bool RAGGED>
int launch_multi_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const float* bias, const __nv_bfloat16* dout, __nv_bfloat16* dq,
                     __nv_bfloat16* dk, __nv_bfloat16* dv, int BH, int S, int W, float scale,
                     const int* seed, int group_rows, unsigned thresh, float inv_keep,
                     int dropout, int causal, int path, int blocks, int smem_bytes,
                     int blocks_kv, int smem_kv, Head hd, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  int G = 0;
  if (!multi_plan_ok(W, nwin, path, blocks, smem_bytes, multi_bwd_smem<DH>(W), G) ||
      blocks_kv != 0 || smem_kv != 0)
    return (int)cudaErrorInvalidValue;
  if (spans_rows(hd, G * W)) {
    constexpr bool SPAN = true;
    K1_MULTI_SWITCH(k1_bwd_multi, blocks, smem_bytes, stream, q, k, v, bias, dout, dq, dk, dv,
                    S, W, G, nwin, scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd)
  }
  constexpr bool SPAN = false;
  K1_MULTI_SWITCH(k1_bwd_multi, blocks, smem_bytes, stream, q, k, v, bias, dout, dq, dk, dv, S,
                  W, G, nwin, scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd)
}

#undef K1_MULTI_SWITCH

}  // namespace k1
