// K1 at head dims past 128: the forward and the backward of
// out = dropout(softmax(q k^T * scale + bias)) v for rows wider than the
// tensor-core kernels of k1_fwd.cuh and k1_bwd.cuh are instantiated at.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149) and _packed_attention_bwd (:164,
// pallas_call at :171), at the head dims the TPU kernel takes whole (it
// blocks over the full Dh, attention.py:120-126).
//
// Shapes and contract as k1_fwd.cuh and k1_bwd.cuh: q, k, v, dout and the
// outputs (BH, S, Dh) rows wherever their layout puts them (k1_tiles.cuh's
// Head), any Dh past 128 (rows whose 16-byte copies would not be aligned, a
// Dh off a multiple of 4 in float32 or of 8 in bf16, or strides and offsets
// off 16 bytes, take the kernels' RAGGED forms: narrower copies, k1_tiles.cuh's
// copy_bytes, and at an odd Dh stores one element at a time);
// any W dividing S up to kMaxRow; the same Philox counters (seed, row,
// i * S + j) and seed groups, causal skips and float32 arithmetic as the
// long-window path (k1_mma.cuh: 3xTF32 in float32, a float32 operand in
// three bf16 parts in bf16), so the results meet the same rules against
// the plain version; no atomics: every sum runs in a fixed order, so two
// launches are bit-equal.
//
// What bounds them. At (256, 80, 10) Dh 256 the function moves 4 (forward)
// or 7 (backward) tensors of 20,480 x 256 elements and does 4 (10) W Dh
// FLOPs a row: about 2.5 FLOP a byte in float32, bound by bytes in both
// dtypes. At W 64 to 256 the FLOPs a byte grow with W, and on grids of a
// block or two an SM the tensor cores' latency sets the pace.
//
// Design. A block holds 64 rows (queries; keys in the dk / dv kernel) and
// 8 warps: warp (rg, ch) owns the 16 rows of group rg = warp % 4 and the
// half ch = warp / 4 of the block's output columns, so a row of 256
// columns needs 64 float32 accumulators a thread, as at Dh 128. The
// block's own rows (q; q and dout; k and v) are staged once, whole, where
// they fit in shared memory (kw::layout), and the other side streams in
// tiles of 32 rows through a ring of three stages where they fit (else
// two), whole rows where they fit, else in column slabs. The logits q k^T (and dout v^T) of a (row tile,
// key tile) are computed once: warp (rg, ch) takes the key half ch of the
// tile against its rows over the whole head dim; the softmax's row max is
// exchanged between the two halves through shared memory, and the
// probabilities (ds; p^T and ds^T) reach the warps that multiply them by
// value (key; dout and q) columns through a (64, 40) float32 tile. Past
// kGroupCols output columns the grid splits them into column groups, each
// of which recomputes the logits (8 warps of 128 columns), and so it does on
// grids so small that twice their blocks fit the card's SMs (groups_of);
// under causal, grids past one block an SM run the tiles with the most work
// first (block_of). bf16 operands reach mma.sync through ldmatrix (.trans
// for the value side). At W <= 32 a
// block holds floor(64 / W) whole windows (consecutive positions of the
// (BH * S) rows, a "super-window", each row's address from its flat
// position: k1_tiles.cuh's Strided, or Divided where it crosses rows); a row's keys
// are its own window's: each warp
// runs only the 8-key column tiles its rows reach, and an element outside
// its window or above a causal diagonal is -inf by its index, reading no
// bias. Columns past Dh (Dh 160 stages 160; Dh 136 stages 144) are
// zero-filled by cp.async with a source size of 0 (plain zeros at bf16's
// 2-byte copies), as rows past W are, and never stored. The backward at W
// <= 64, where a block holds whole windows, is one kernel
// (k1_bwd_wide_win): the logits and dout v^T once, a
// softmax over (64, 64) tiles in shared memory, then dq, dk and dv, so two
// products over the head dim and three over the outputs' columns a pair.
// Past W 64 it is the two-sweep dq kernel (its first sweep each half's
// running max, normaliser and sum of p dp, merged at its end; each
// position's max, 1 / normaliser and D go to `stats`, 3 floats a position,
// ops/attention.py backward_scratch) and the dk / dv kernel.
//
// The entry points are packed_attention_wide.cu (float32) and
// packed_attention_wide_bf16.cu, a library a dtype, built in parallel with
// the others (ops/kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "k1_mma.cuh"
#include "philox.cuh"

namespace {
namespace kw {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;                     // a block's rows: four groups of 16
constexpr int kCols = 32;                     // a streamed tile's rows, 16 a key half
constexpr int kGroupCols = 256;               // the most output columns a block owns
constexpr int kHalfTiles = kGroupCols / 16;   // a warp's output column tiles, at most
constexpr int kXS = kCols + 8;                // float row stride of the exchange tiles
constexpr int kMultiWindow = 32;              // W at or below: 64 / W windows a block
constexpr int kSplitBelow = 132;              // the H100's SMs: small grids split columns
constexpr int kWinMax = 64;                   // W at or below: the one-kernel backward
constexpr int kWS = kRows + 4;                // float row stride of its (64, 64) tiles
constexpr int kWinSmem = 115712;              // two blocks an SM: (233,472 - 2 x 1 KB) / 2
constexpr int kKeepTiles = 32;                // the dq kernel keeps its sweep-1 keep bits
                                              // for this many key tiles (W <= 1024)

enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// a staged row of w elements, padded by 16 bytes (k1_mma.cuh's bank rule)
__host__ __device__ constexpr int row_bytes(int w, int E) { return w * E + 16; }

// A kernel's shared memory and slabs (ops/attention.py::wide_layout mirrors it).
struct Layout {
  int Dp;      // staged columns: Dh rounded up to 16
  int groups;  // output column groups
  int CW;      // columns of a group, a multiple of 16
  int SW;      // columns of a contraction slab
  int nslab;   // slabs of Dp
  int res;     // the block's own rows staged once, whole (else with each slab)
  int merged;  // one slab and one group: the products read the slab's own tiles
  int stage;   // bytes of a ring stage
  int ns;      // ring stages: 3 where they fit, else 2
  int smem;    // bytes in all (0: nothing fits)
};

__host__ __device__ constexpr int group_cols(int Dp, int groups) {
  return cdiv(cdiv(Dp, groups), 16) * 16;
}
// The column groups: as few as 256 columns a group allows, doubled while twice the grid's
// blocks fit the card's SMs (one block an SM) and a group holds more than 64 columns.
__host__ __device__ inline int groups_of(int Dh, long long row_blocks) {
  const int Dp = cdiv(Dh, 16) * 16;
  int groups = cdiv(Dp, kGroupCols);
  while (2 * row_blocks * groups <= kSplitBelow && group_cols(Dp, groups) > 64) groups *= 2;
  return groups;
}

// Own rows A (q; q, dout; k, v), streamed rows B a slab (k; k, v; q, dout), the exchange
// tiles and statistics (fwd: p_drop and the halves' row max; dq: ds and the halves' m, l
// and sum p dp; dk / dv: p_drop^T, ds^T and three buffers of 32 rows' 3 statistics). The
// first that fits 227 KB of: merged (whole rows, one group; the forward's stage also holds
// v's tile), own rows resident with slabs of 256, 128 or 64 columns, every row streamed
// in slabs. A product stage holds one tensor's group columns (v; k; dout, then q).
// A third ring stage where it fits: the copies of two steps in flight behind the one
// computed.
__host__ __device__ inline Layout third_stage(Layout L) {
  L.ns = 2;
  if (L.smem + L.stage <= k1::kSmemLimit) L.ns = 3, L.smem += L.stage;
  return L;
}

__host__ __device__ inline Layout layout(int Dh, int E, int kernel, int groups) {
  Layout L{};
  L.Dp = cdiv(Dh, 16) * 16;
  L.groups = groups;
  L.CW = group_cols(L.Dp, groups);
  const int A = kernel == kFwd ? kRows : 2 * kRows;
  const int B = kernel == kFwd ? kCols : 2 * kCols;
  const int fixed = (kernel == kDkv ? 2 : 1) * kRows * kXS * 4 +
                    (kernel == kFwd ? 2 * kRows : kernel == kDq ? 6 * kRows : 9 * kCols) * 4 +
                    (kernel == kDq ? kKeepTiles * kThreads : 0);
  const int prod = kCols * row_bytes(L.CW, E);
  if (L.groups == 1) {
    const int stage = (kernel == kFwd ? 2 * kCols : B) * row_bytes(L.Dp, E);
    const int smem = A * row_bytes(L.Dp, E) + 2 * stage + fixed;
    if (smem <= k1::kSmemLimit) {
      L.SW = L.Dp, L.nslab = 1, L.res = 1, L.merged = 1, L.stage = stage, L.smem = smem;
      return third_stage(L);
    }
  }
  for (int res = 1; res >= 0; --res)
    for (int SW = 256; SW >= 64; SW /= 2) {
      if (SW >= L.Dp) continue;
      const int slab = (B + (res ? 0 : A)) * row_bytes(SW, E);
      const int stage = slab > prod ? slab : prod;
      const int smem = (res ? A * row_bytes(L.Dp, E) : 0) + 2 * stage + fixed;
      if (smem <= k1::kSmemLimit) {
        L.SW = SW, L.nslab = cdiv(L.Dp, SW), L.res = res, L.merged = 0, L.stage = stage;
        L.smem = smem;
        return third_stage(L);
      }
    }
  return L;
}

// The one-kernel backward (W <= kWinMax, k1_bwd_wide_win): a ring whose stage holds a slab
// of the block's 64 rows of q, dout, k and v (the logits) or 32 rows of one tensor's group
// columns (the products), two float32 (64, 64) tiles (s then p_drop; dp then ds) and a keep
// byte an element; the widest slab of 256 down to 16 columns with which two stages fit
// two blocks an SM (kWinSmem; in float32 the kernel is bound to 128 registers a thread for
// it; the bf16 kernel's products would spill at 128 and run one block an SM), else one
// block an SM.
__host__ __device__ inline Layout win_layout(int Dh, int E, int groups) {
  Layout L{};
  L.Dp = cdiv(Dh, 16) * 16;
  L.groups = groups;
  L.CW = group_cols(L.Dp, groups);
  L.res = 0;
  const int fixed = 2 * kRows * kWS * 4 + kRows * kRows;
  const int prod = kCols * row_bytes(L.CW, E);
  for (int pass = 0; pass < 2; ++pass)
    for (int SW = 256; SW >= 16; SW /= 2) {
      const int limit = pass ? k1::kSmemLimit : kWinSmem;
      if (SW > L.Dp && SW > 16) continue;
      const int slab = 4 * kRows * row_bytes(SW, E);
      const int stage = slab > prod ? slab : prod;
      if (2 * stage + fixed <= limit) {
        L.SW = SW, L.nslab = cdiv(L.Dp, SW), L.merged = 0, L.stage = stage, L.ns = 2;
        L.smem = 2 * stage + fixed;
        return L;
      }
    }
  return L;
}

// The grid: G windows a block (floor(64 / W) at W <= 32, else 1), `tiles` row tiles of a
// super-window, `groups` column groups (groups_of); block b = ((super-window, tile), group).
struct Grid {
  int G, tiles, groups;
  long long blocks;
};
__host__ __device__ inline Grid grid_of(long long nwin, int W, int Dh) {
  Grid g;
  g.G = W <= kMultiWindow ? kRows / W : 1;
  g.tiles = g.G > 1 ? 1 : cdiv(W, kRows);
  const long long rows = (nwin + g.G - 1) / g.G * g.tiles;
  g.groups = groups_of(Dh, rows);
  g.blocks = rows * g.groups;
  return g;
}

// A block's place: its column group, its rows i0 .. i0 + 63 of a super-window of Wb rows
// (G windows, or one) whose first position in the (BH * S) rows is gbase. Blocks go
// (super-window, tile)-major, but under causal with several tiles a window, on grids of
// more than one block an SM, tile-major, the tiles with the most work first (the last row
// tiles of the forward and the dq kernel, `last_first`; the first key tiles of the dk / dv
// kernel), so the card's last blocks are its shortest.
struct Block {
  int cg, i0, Wb;
  long long gbase;
};
__device__ __forceinline__ Block block_of(int nwin, int W, int G, int tiles, int groups,
                                          int causal = 0, bool last_first = true) {
  Block b;
  b.cg = blockIdx.x % groups;
  const int rest = blockIdx.x / groups;
  int sw, qt;
  if (causal && tiles > 1 && gridDim.x > kSplitBelow) {
    const int nsw = (nwin + G - 1) / G, tq = rest / nsw;
    sw = rest - tq * nsw;
    qt = last_first ? tiles - 1 - tq : tq;
  } else {
    sw = rest / tiles;
    qt = rest - sw * tiles;
  }
  b.i0 = qt * kRows;
  const int n0 = sw * G;
  b.Wb = min(G, nwin - n0) * W;
  b.gbase = (long long)n0 * W;
  return b;
}

// One of a thread's rows r (super-window coordinates): its partners (a query's keys; a
// key's queries, `keys`) [lo, hi), its bias index and Philox counter base (partner p at
// cb + p * pstride: 1 for a query's keys, S for a key's queries) and its row's seed.
struct Row {
  int lo, hi;
  long long cb;
  unsigned seed, prow;
};
__device__ __forceinline__ Row row_of(int r, int Wb, int W, long long gbase, int S, int causal,
                                      bool keys, const int* seed_ptr, int group_rows,
                                      int dropout) {
  Row R{0, 0, 0, 0u, 0u};
  if (r >= Wb) return R;
  const int w0 = r / W * W;
  R.lo = keys && causal ? r : w0;
  R.hi = !keys && causal ? r + 1 : min(w0 + W, Wb);
  const long long gp = gbase + r;
  const int bh = (int)(gp / S), p = (int)(gp - (long long)bh * S);
  R.cb = keys ? (long long)(p - r) * S + p : (long long)p * S + p - r;
  if (dropout) {
    const unsigned grp = (unsigned)bh / (unsigned)group_rows;
    R.seed = (unsigned)__ldg(seed_ptr + grp);
    R.prow = (unsigned)bh - grp * (unsigned)group_rows;
  }
  return R;
}

// The partners [lo, hi) that rows r0 .. r0 + n - 1 (a warp's 16; a block's 64) reach.
__device__ __forceinline__ void reach(int r0, int n, int Wb, int W, int causal, bool keys,
                                      int& lo, int& hi) {
  lo = hi = 0;
  if (r0 >= Wb) return;
  const int rl = min(r0 + n - 1, Wb - 1);
  lo = keys && causal ? r0 : r0 / W * W;
  hi = !keys && causal ? rl + 1 : min((rl / W + 1) * W, Wb);
}

// The 8-wide column tiles [b, e) of the n tiles from partner p0 that [lo, hi) reaches.
__device__ __forceinline__ void tiles_in(int lo, int hi, int p0, int n, int& b, int& e) {
  if (hi <= p0 || lo >= p0 + 8 * n) {
    b = e = 0;
    return;
  }
  b = max(0, lo - p0) / 8;
  e = min(n, (hi - p0 + 7) / 8);
}

// The keep bits of the thread's elements of a warp's (16, 16) half tile: bit 4x + e for
// element e of column tile x (row R[e >> 1], partner p0 + 8x + 2t + (e & 1)); partners
// outside a row's [lo, hi) draw nothing. TWO: unrolled by two (two copies of the
// generator, two independent chains of its rounds), else one copy (the dk / dv kernel,
// whose accumulators leave no registers for a second).
__device__ __forceinline__ unsigned keep_bit(const Row (&R)[2], int p0, int pstride,
                                             unsigned thresh, int t, int b) {
  const int x = b >> 2, e = b & 3, h = e >> 1;
  const int lo = h ? R[1].lo : R[0].lo, hi = h ? R[1].hi : R[0].hi;
  const int p = p0 + 8 * x + 2 * t + (e & 1);
  if (p < lo || p >= hi) return 0u;
  const long long idx = (h ? R[1].cb : R[0].cb) + (long long)p * pstride;
  const unsigned bits =
      attn_keep_bits(h ? R[1].seed : R[0].seed, h ? R[1].prow : R[0].prow, (unsigned)idx);
  return (unsigned)(bits < thresh) << b;
}

template <bool TWO = true>
__device__ __forceinline__ unsigned keep_mask(const Row (&R)[2], int p0, int pstride,
                                              unsigned thresh, int lane) {
  const int t = lane & 3;
  unsigned m = 0u;
  if (TWO) {
#pragma unroll 2
    for (int b = 0; b < 8; ++b) m |= keep_bit(R, p0, pstride, thresh, t, b);
  } else {
#pragma unroll 1
    for (int b = 0; b < 8; ++b) m |= keep_bit(R, p0, pstride, thresh, t, b);
  }
  return m;
}

// One tensor's rows: row r at p + ro(r) (the super-window's rows: k1_tiles.cuh's Strided,
// or Divided where a super-window crosses from one row n to the next).
template <typename Elem, typename RO>
struct Src {
  const Elem* p;
  RO ro;
  __device__ __forceinline__ Src from(int r) const { return Src{p, ro.from(r)}; }
};

// Issue the copies of `rows` rows of `w` columns (a multiple of 16) from column c0 of
// `src` into `dst` (row stride ls); rows at or past `valid` and columns at or past Dh
// are zero-filled, reading nothing. 16-byte copies; RAGGED (rows not all 16-byte
// aligned: k1_tiles.cuh's layout_copy): copies of hd.copy bytes.
template <bool RAGGED, typename Elem, typename RO>
__device__ __forceinline__ void stage_cols(Elem* dst, int ls, const Src<Elem, RO>& src, int rows,
                                           int valid, int c0, int w, const k1::Head& hd) {
  const RO& ro = src.ro;
  if constexpr (RAGGED) {
    k1::stage_ragged(dst, ls, src.p, ro, rows, valid, c0, w, hd, src.p);
  } else {
    constexpr int E = 16 / (int)sizeof(Elem);
    const int n = w / E;
    for (int e = threadIdx.x; e < rows * n; e += kThreads) {
      const int r = e / n, c = e - r * n, col = c0 + c * E;
      const bool ok = r < valid && col < hd.Dh;
      k1::cp_async16_zfill(dst + r * ls + c * E, ok ? src.p + ro(r) + col : src.p, ok);
    }
  }
}

// acc[p][x] += X[p][16 rows] . Y[p][rows 8x .. 8x + 8)^T over kc columns (a multiple of
// 16) for NP products at once (the backward's s and dp) and the column tiles X0 <= x <
// X1; row strides lx and ly. With NH = 2 every other k step goes to a second accumulator,
// added at the end: NP x (X1 - X0) x NH independent chains of mma.sync. As k1_mma.cuh's
// gemm_nt: 3xTF32 (small terms first) in float32, exact bf16 products in bf16. No
// mma.sync is under a condition of its own: the compiler would fence each with a warp
// sync.
template <int X0, int X1, int NP, int NH>
__device__ __forceinline__ void mma_nt_run(float (&acc)[NP][2][4], const float* const (&X)[NP],
                                           int lx, const float* const (&Y)[NP], int ly, int kc,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  float odd[NP][2][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kc; kk += 8 * NH) {
    unsigned ah[NH][NP][4], al[NH][NP][4], bh[NH][NP][2][2], bl[NH][NP][2][2];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float* xa = X[p] + g * lx + kk + 8 * h + t;
        k1::split_tf32(xa[0], ah[h][p][0], al[h][p][0]);
        k1::split_tf32(xa[8 * lx], ah[h][p][1], al[h][p][1]);
        k1::split_tf32(xa[4], ah[h][p][2], al[h][p][2]);
        k1::split_tf32(xa[8 * lx + 4], ah[h][p][3], al[h][p][3]);
#pragma unroll
        for (int x = X0; x < X1; ++x) {
          const float* yb = Y[p] + (x * 8 + g) * ly + kk + 8 * h + t;
          k1::split_tf32(yb[0], bh[h][p][x][0], bl[h][p][x][0]);
          k1::split_tf32(yb[4], bh[h][p][x][1], bl[h][p][x][1]);
        }
      }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int x = X0; x < X1; ++x)
          k1::mma_tf32(h ? odd[p][x] : acc[p][x], al[h][p], bh[h][p][x]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int x = X0; x < X1; ++x)
          k1::mma_tf32(h ? odd[p][x] : acc[p][x], ah[h][p], bl[h][p][x]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int x = X0; x < X1; ++x)
          k1::mma_tf32(h ? odd[p][x] : acc[p][x], ah[h][p], bh[h][p][x]);
  }
  if (NH > 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int x = X0; x < X1; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][x][e] += odd[p][x][e];
  }
}

// Four 8 x 8 bf16 matrices from the rows each lane addresses (lanes 8m .. 8m + 7 matrix m).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// In bf16 one ldmatrix gives a k step's A fragment (lane l: row 8 ((l >> 3) & 1) + (l & 7),
// column 8 (l >> 4)) and one the B fragments of both column tiles (lane l: key row
// 8 (l >> 4) + (l & 7), column 8 ((l >> 3) & 1)); with one tile in range the other's are
// loaded and left.
template <int X0, int X1, int NP, int NH>
__device__ __forceinline__ void mma_nt_run(float (&acc)[NP][2][4],
                                           const __nv_bfloat16* const (&X)[NP], int lx,
                                           const __nv_bfloat16* const (&Y)[NP], int ly, int kc,
                                           int lane) {
  const int ar = ((lane >> 3) & 1) * 8 + (lane & 7), ac = (lane >> 4) * 8;
  const int br = (lane >> 4) * 8 + (lane & 7), bc = ((lane >> 3) & 1) * 8;
  float odd[NP][2][4] = {};
  int kk = 0;
#pragma unroll 2
  for (; kk + 16 * NH <= kc; kk += 16 * NH) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        unsigned a[4], b[4];
        ldsm_x4(a, X[p] + ar * lx + kk + 16 * h + ac);
        ldsm_x4(b, Y[p] + br * ly + kk + 16 * h + bc);
#pragma unroll
        for (int x = X0; x < X1; ++x) {
          const unsigned bx[2] = {b[2 * x], b[2 * x + 1]};
          k1::mma_bf16(h ? odd[p][x] : acc[p][x], a, bx);
        }
      }
  }
  if (kk < kc) {   // an odd multiple of 16 with NH = 2: the last k step
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      unsigned a[4], b[4];
      ldsm_x4(a, X[p] + ar * lx + kk + ac);
      ldsm_x4(b, Y[p] + br * ly + kk + bc);
#pragma unroll
      for (int x = X0; x < X1; ++x) {
        const unsigned bx[2] = {b[2 * x], b[2 * x + 1]};
        k1::mma_bf16(acc[p][x], a, bx);
      }
    }
  }
  if (NH > 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int x = X0; x < X1; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][x][e] += odd[p][x][e];
  }
}

// The warp's column tiles [xb, xe) of its half tile (xb, xe warp-uniform), each range a
// loop of its own.
template <int NP, int NH, typename Elem>
__device__ __forceinline__ void mma_nt(float (&acc)[NP][2][4], const Elem* const (&X)[NP],
                                       int lx, const Elem* const (&Y)[NP], int ly, int kc,
                                       int lane, int xb, int xe) {
  if (xb == 0 && xe == 2)
    mma_nt_run<0, 2, NP, NH>(acc, X, lx, Y, ly, kc, lane);
  else if (xb == 0 && xe == 1)
    mma_nt_run<0, 1, NP, NH>(acc, X, lx, Y, ly, kc, lane);
  else if (xb == 1 && xe == 2)
    mma_nt_run<1, 2, NP, NH>(acc, X, lx, Y, ly, kc, lane);
}

// acc[n] += P . Z[:, 8n .. 8n + 8) for the n < nact output tiles: P the warp's (16, 32)
// tile in the accumulator layout, Z 32 rows (row stride lz). Only P's column tiles
// [kb, ke) are read (the others are 0); in bf16 they go in pairs. As k1_mma.cuh's gemm_pv;
// the output tiles go in groups of k1::kGroup, each group's products under one
// (warp-uniform) condition, a group that nact cuts short one product at a time.
template <int NO>
__device__ __forceinline__ void mma_pv(float (&acc)[NO][4], const float (&p)[4][4],
                                       const float* Z, int lz, int lane, int nact, int kb,
                                       int ke) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    if (kt < kb || kt >= ke) continue;
    unsigned ah[4], al[4];
    k1::split_tf32(p[kt][0], ah[0], al[0]);
    k1::split_tf32(p[kt][2], ah[1], al[1]);
    k1::split_tf32(p[kt][1], ah[2], al[2]);
    k1::split_tf32(p[kt][3], ah[3], al[3]);
    const float* z = Z + (kt * 8 + 2 * t) * lz + g;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += k1::kGroup) {
      if (n0 >= nact) continue;
      unsigned bh[k1::kGroup][2], bl[k1::kGroup][2];
      if (n0 + k1::kGroup <= nact) {
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) {
          k1::split_tf32(z[(n0 + u) * 8], bh[u][0], bl[u][0]);
          k1::split_tf32(z[lz + (n0 + u) * 8], bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) k1::mma_tf32(acc[n0 + u], al, bh[u]);
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) k1::mma_tf32(acc[n0 + u], ah, bl[u]);
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) k1::mma_tf32(acc[n0 + u], ah, bh[u]);
      } else {
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) {
          if (n0 + u >= nact) continue;
          k1::split_tf32(z[(n0 + u) * 8], bh[u][0], bl[u][0]);
          k1::split_tf32(z[lz + (n0 + u) * 8], bh[u][1], bl[u][1]);
          k1::mma_tf32(acc[n0 + u], al, bh[u]);
          k1::mma_tf32(acc[n0 + u], ah, bl[u]);
          k1::mma_tf32(acc[n0 + u], ah, bh[u]);
        }
      }
    }
  }
}

// Four 8 x 8 bf16 matrices, transposed, from the rows each lane addresses (lanes 8m .. 8m +
// 7 matrix m): the B fragments of two m16n8k16 column tiles.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// In bf16 the B fragments of two column tiles come from one ldmatrix.trans of Z's 16 rows
// (row-major, 16-byte aligned rows): lane l addresses row 8 ((l >> 3) & 1) + (l & 7) at
// column 8 (l >> 4). Past nact it may read one tile more of the rows (their columns or
// their 16-byte padding), and multiplies it by nothing.
template <int NO>
__device__ __forceinline__ void mma_pv(float (&acc)[NO][4], const float (&p)[4][4],
                                       const __nv_bfloat16* Z, int lz, int lane, int nact,
                                       int kb, int ke) {
  const __nv_bfloat16* zl = Z + (((lane >> 3) & 1) * 8 + (lane & 7)) * lz + (lane >> 4) * 8;
#pragma unroll
  for (int kp = 0; kp < 2; ++kp) {
    if (2 * kp + 1 < kb || 2 * kp >= ke) continue;
    unsigned a[4][3];
    k1::split3_bf16x2(p[2 * kp][0], p[2 * kp][1], a[0]);
    k1::split3_bf16x2(p[2 * kp][2], p[2 * kp][3], a[1]);
    k1::split3_bf16x2(p[2 * kp + 1][0], p[2 * kp + 1][1], a[2]);
    k1::split3_bf16x2(p[2 * kp + 1][2], p[2 * kp + 1][3], a[3]);
    const __nv_bfloat16* z = zl + kp * 16 * lz;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += k1::kGroup) {
      if (n0 >= nact) continue;
      unsigned b[k1::kGroup][2];
      unsigned r[4];
      ldsm_x4_trans(r, z + n0 * 8);
      b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
      if (n0 + 2 < nact) {
        ldsm_x4_trans(r, z + (n0 + 2) * 8);
        b[2][0] = r[0], b[2][1] = r[1], b[3][0] = r[2], b[3][1] = r[3];
      }
      if (n0 + k1::kGroup <= nact) {
#pragma unroll
        for (int part = 2; part >= 0; --part) {   // lo, mid, hi
          const unsigned ap[4] = {a[0][part], a[1][part], a[2][part], a[3][part]};
#pragma unroll
          for (int u = 0; u < k1::kGroup; ++u) k1::mma_bf16(acc[n0 + u], ap, b[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < k1::kGroup; ++u) {
          if (n0 + u >= nact) continue;
#pragma unroll
          for (int part = 2; part >= 0; --part) {
            const unsigned ap[4] = {a[0][part], a[1][part], a[2][part], a[3][part]};
            k1::mma_bf16(acc[n0 + u], ap, b[u]);
          }
        }
      }
    }
  }
}

// The warp's (16, 32) tile of an exchange tile (rows lr and lr + 8 of the block), in the
// accumulator layout.
__device__ __forceinline__ void load_tile(float (&p)[4][4], const float* X, int lr, int lane) {
  const float* a = X + lr * kXS + 2 * (lane & 3);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 u = *reinterpret_cast<const float2*>(a + 8 * x);
    const float2 w = *reinterpret_cast<const float2*>(a + 8 * kXS + 8 * x);
    p[x][0] = u.x, p[x][1] = u.y, p[x][2] = w.x, p[x][3] = w.y;
  }
}

// The thread's elements of a warp's (16, 16) half tile into an exchange tile, at column
// 16 ch.
__device__ __forceinline__ void put_half(float* X, const float (&v)[2][4], int lr, int ch,
                                         int lane) {
  float* a = X + lr * kXS + 16 * ch + 2 * (lane & 3);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    *reinterpret_cast<float2*>(a + 8 * x) = make_float2(v[x][0], v[x][1]);
    *reinterpret_cast<float2*>(a + 8 * kXS + 8 * x) = make_float2(v[x][2], v[x][3]);
  }
}

// Store the warp's (16, 8 nact) accumulator at columns c0 + 8n of rows ra and ra + 8 (those
// below Wb; columns below Dh), row r at dst + ro(r), each value times its row's factor: in
// pairs (RAGGED where the pairs are not all aligned: k1_mma.cuh's store2_ragged).
template <typename Elem, int NO, bool RAGGED, typename RO>
__device__ __forceinline__ void store_cols(Elem* dst, const RO& ro, const float (&acc)[NO][4],
                                           int ra, int Wb, float fa, float fb, int lane,
                                           const k1::Head& hd, int c0, int nact) {
  const int t = lane & 3, Dh = hd.Dh;
  const bool pair = hd.copy >= 2 * (int)sizeof(Elem);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    if (n >= nact || c >= Dh) continue;
    if constexpr (RAGGED) {
      if (ra < Wb)
        k1::store2_ragged(dst + ro(ra) + c, acc[n][0] * fa, acc[n][1] * fa, c, Dh, pair);
      if (ra + 8 < Wb)
        k1::store2_ragged(dst + ro(ra + 8) + c, acc[n][2] * fb, acc[n][3] * fb, c, Dh, pair);
    } else {
      if (ra < Wb) k1::store2(dst + ro(ra) + c, acc[n][0] * fa, acc[n][1] * fa);
      if (ra + 8 < Wb) k1::store2(dst + ro(ra + 8) + c, acc[n][2] * fb, acc[n][3] * fb);
    }
  }
}

// Wait for all but the ring's ns - 1 youngest commit groups: step it's stage has landed.
__device__ __forceinline__ void ring_wait(int ns) {
  if (ns == 3)
    k1::cp_async_wait<2>();
  else
    k1::cp_async_wait<1>();
}

__device__ __forceinline__ void zero2(float (&a)[2][4]) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[x][e] = 0.f;
}

}  // namespace kw

// Forward: block (super-window tile, column group). Per key tile, steps (kt, c < nslab)
// add q_c k_c^T to the warp's (16, 16) logits; after the last slab the warps take the
// online softmax (the row max of both halves through `red`), draw the keep bits and put
// p_drop in the exchange tile; then (in the same step if merged, else in step (kt, nslab),
// which stages v's group) each warp adds p_drop v to its output columns. out = acc / l, l
// the two halves' sums.
template <typename Elem, bool RAGGED, bool SPAN>
__global__ void __launch_bounds__(kw::kThreads)
k1_fwd_wide(const Elem* __restrict__ q, const Elem* __restrict__ k,
            const Elem* __restrict__ v, const float* __restrict__ bias,
            Elem* __restrict__ out, int S, int W, int Dh, int nwin, int G, int tiles,
            kw::Layout L, float scale, const int* __restrict__ seed_ptr, int group_rows,
            unsigned thresh, float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace kw;
  constexpr int E = (int)sizeof(Elem);
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int lsD = L.Dp + 16 / E, lsS = L.SW + 16 / E, lsC = L.CW + 16 / E;
  Elem* qres = reinterpret_cast<Elem*>(sm);   // the block's q rows (L.res)
  char* ring = sm + (L.res ? kRows * row_bytes(L.Dp, E) : 0);
  float* xp = reinterpret_cast<float*>(ring + L.ns * L.stage);   // (kRows, kXS) p_drop
  float* red = xp + kRows * kXS;                                // (2, kRows) row max, l

  const Block B = block_of(nwin, W, G, tiles, L.groups, causal);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, lr = rg * 16 + (lane >> 2), ra = B.i0 + lr;
  const auto rin = k1::block_rows<SPAN>(hd, k1::kIn, (unsigned)B.gbase);   // the block's rows
  using RO = std::decay_t<decltype(rin)>;
  const Src<Elem, RO> qb{q, rin.from(B.i0)}, kb{k, rin}, vb{v, rin};
  K1_PHASE_BEGIN();
  const Row R[2] = {
      row_of(ra, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout),
      row_of(ra + 8, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout)};
  int wlo, whi, blo, bhi;   // the keys the warp's rows and the block's rows reach
  reach(B.i0 + rg * 16, 16, B.Wb, W, causal, false, wlo, whi);
  reach(B.i0, kRows, B.Wb, W, causal, false, blo, bhi);
  const int nk = cdiv(bhi, kCols), per = L.nslab + (L.merged ? 0 : 1), steps = nk * per;
  const int HW = L.CW / 2, oc0 = B.cg * L.CW + ch * HW;
  const int nact = max(0, min(HW, L.Dp - oc0)) / 8;

  const auto stage = [&](int it) {
    const int kt = it / per, c = it - kt * per, j1 = kt * kCols;
    Elem* d = reinterpret_cast<Elem*>(ring + (it % L.ns) * L.stage);
    if (c < L.nslab) {
      const int c0 = c * L.SW, w = min(L.SW, L.Dp - c0);
      if (!L.res) {
        stage_cols<RAGGED>(d, lsS, qb, kRows, B.Wb - B.i0, c0, w, hd);
        d += kRows * lsS;
      }
      stage_cols<RAGGED>(d, lsS, kb.from(j1), kCols, B.Wb - j1, c0, w, hd);
      if (L.merged)
        stage_cols<RAGGED>(d + kCols * lsS, lsS, vb.from(j1), kCols, B.Wb - j1, 0, L.Dp, hd);
    } else {
      stage_cols<RAGGED>(d, lsC, vb.from(j1), kCols, B.Wb - j1, B.cg * L.CW, L.CW, hd);
    }
  };
  if (L.res) stage_cols<RAGGED>(qres, lsD, qb, kRows, B.Wb - B.i0, 0, L.Dp, hd);
  for (int i = 0; i < L.ns - 1; ++i) {   // the ring's first stages, a commit group each
    if (i < steps) stage(i);
    k1::cp_async_commit();
  }

  float o[kHalfTiles][4] = {};
  float sp[1][2][4];
  float(&s)[2][4] = sp[0];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    if (it + L.ns - 1 < steps) stage(it + L.ns - 1);
    k1::cp_async_commit();
    ring_wait(L.ns);
    __syncthreads();
    K1_PHASE(0);
    const Elem* st = reinterpret_cast<const Elem*>(ring + (it % L.ns) * L.stage);
    const int kt = it / per, c = it - kt * per, j0 = kt * kCols + ch * 16;
    int xb, xe, pb, pe;   // the warp's key tiles of its half, and of the whole tile
    tiles_in(wlo, whi, j0, 2, xb, xe);
    tiles_in(wlo, whi, kt * kCols, 4, pb, pe);
    if (c == 0) zero2(s);
    if (c < L.nslab) {
      const Elem* X[1] = {L.res ? qres + (rg * 16) * lsD + c * L.SW : st + (rg * 16) * lsS};
      const Elem* Y[1] = {st + (L.res ? 0 : kRows * lsS) + (ch * 16) * lsS};
      mma_nt<1, 2>(sp, X, L.res ? lsD : lsS, Y, lsS, min(L.SW, L.Dp - c * L.SW), lane, xb,
                   xe);
      K1_PHASE(1);
    }
    if (c == L.nslab - 1) {   // the tile's logits are whole
      const unsigned keep = dropout ? keep_mask(R, j0, 1, thresh, lane) : 0u;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Row& r = R[e >> 1];
          const int j = j0 + 8 * x + 2 * t + (e & 1);
          const float y = j >= r.lo && j < r.hi ? s[x][e] * scale + __ldg(bias + r.cb + j)
                                                : -INFINITY;
          s[x][e] = y;
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = k1::quad_max(mx[h]);
        if (t == 0) red[ch * kRows + lr + 8 * h] = mx[h];
      }
      __syncthreads();
      float ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], fmaxf(red[lr + 8 * h], red[kRows + lr + 8 * h]));
        ms[h] = mn == -INFINITY ? 0.f : mn;   // a row with no key yet: p = 0
        const float corr = __expf(m[h] - ms[h]);
        m[h] = mn;
        l[h] *= corr;
#pragma unroll
        for (int n = 0; n < kHalfTiles; ++n) {
          o[n][2 * h] *= corr;
          o[n][2 * h + 1] *= corr;
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = __expf(s[x][e] - ms[h]);
          l[h] += p;
          s[x][e] = !dropout ? p : (keep >> (4 * x + e)) & 1u ? p * inv_keep : 0.f;
        }
      put_half(xp, s, lr, ch, lane);
      K1_PHASE(2);
      if (L.merged) {
        __syncthreads();
        float pf[4][4];
        load_tile(pf, xp, lr, lane);
        mma_pv<kHalfTiles>(o, pf, st + kCols * lsS + oc0, lsS, lane, nact, pb, pe);
      }
    } else if (c == L.nslab) {   // v's group
      float pf[4][4];
      load_tile(pf, xp, lr, lane);
      mma_pv<kHalfTiles>(o, pf, st + ch * HW, lsC, lane, nact, pb, pe);
    }
    K1_PHASE(3);
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = k1::quad_sum(l[h]);
    if (t == 0) red[ch * kRows + lr + 8 * h] = l[h];
  }
  __syncthreads();
  const float la = red[lr] + red[kRows + lr], lb = red[lr + 8] + red[kRows + lr + 8];
  store_cols<Elem, kHalfTiles, RAGGED>(out, k1::block_rows<SPAN>(hd, k1::kOut, (unsigned)B.gbase),
                                       o, ra, B.Wb, 1.f / la, 1.f / lb, lane, hd, oc0, nact);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

// The two-sweep dq kernel: block (super-window tile, column group) owns 64 query rows
// with their q and dout. Sweep 1, steps (kt, c < nslab): the warp's (16, 16) logits and
// dout v^T; after the last slab its keep bits and its half's running max, l and sum p dp
// (k1_bwd_mma_dq's, over the half's keys). At its end the halves merge (through `red`)
// into each row's max m, 1 / l and D, which the warps of column group 0 write to `stats`.
// Sweep 2 recomputes s and dp, puts ds = p (dp - D) scale in the exchange tile and (in
// the same step if merged, else in step (kt, nslab), which stages k's group) adds ds k to
// the warp's dq columns.
template <typename Elem, bool RAGGED>
__global__ void __launch_bounds__(kw::kThreads)
k1_bwd_wide_dq(const Elem* __restrict__ q, const Elem* __restrict__ k,
               const Elem* __restrict__ v, const float* __restrict__ bias,
               const Elem* __restrict__ dout, Elem* __restrict__ dq, float* __restrict__ stats,
               int S, int W, int Dh, int nwin, int G, int tiles, kw::Layout L,
               size_t positions, float scale, const int* __restrict__ seed_ptr,
               int group_rows, unsigned thresh, float inv_keep, int dropout, int causal,
               k1::Head hd) {
  using namespace kw;
  constexpr int E = (int)sizeof(Elem);
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int lsD = L.Dp + 16 / E, lsS = L.SW + 16 / E, lsC = L.CW + 16 / E;
  Elem* qres = reinterpret_cast<Elem*>(sm);   // q rows, then dout rows (L.res)
  Elem* ores = qres + kRows * lsD;
  char* ring = sm + (L.res ? 2 * kRows * row_bytes(L.Dp, E) : 0);
  float* xd = reinterpret_cast<float*>(ring + L.ns * L.stage);   // (kRows, kXS) ds
  float* red = xd + kRows * kXS;                                // (3, 2, kRows)
  unsigned char* kbits = reinterpret_cast<unsigned char*>(red + 6 * kRows);   // sweep 1's

  const Block B = block_of(nwin, W, G, tiles, L.groups, causal);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, lr = rg * 16 + (lane >> 2), ra = B.i0 + lr;
  // the block's rows: past kWinMax a block holds one window's tile, one run
  const k1::Strided rin = k1::block_rows<false>(hd, k1::kIn, (unsigned)B.gbase);
  using RO = k1::Strided;
  const k1::Strided rout = k1::block_rows<false>(hd, k1::kOut, (unsigned)B.gbase);
  const Src<Elem, RO> qb{q, rin.from(B.i0)}, ob{dout, rout.from(B.i0)}, kb{k, rin}, vb{v, rin};
  K1_PHASE_BEGIN();
  const Row R[2] = {
      row_of(ra, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout),
      row_of(ra + 8, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout)};
  int wlo, whi, blo, bhi;
  reach(B.i0 + rg * 16, 16, B.Wb, W, causal, false, wlo, whi);
  reach(B.i0, kRows, B.Wb, W, causal, false, blo, bhi);
  const int nk = cdiv(bhi, kCols), per = L.nslab + (L.merged ? 0 : 1);
  const int sweep1 = nk * L.nslab, steps = sweep1 + nk * per;
  const int HW = L.CW / 2, oc0 = B.cg * L.CW + ch * HW;
  const int nact = max(0, min(HW, L.Dp - oc0)) / 8;

  const auto step_of = [&](int it, int& kt, int& c) {
    if (it < sweep1) {
      kt = it / L.nslab;
      c = it - kt * L.nslab;
    } else {
      kt = (it - sweep1) / per;
      c = it - sweep1 - kt * per;
    }
  };
  // a slab stage: [q, dout slabs (kRows rows each) unless resident] k, v slabs (kCols)
  const auto stage = [&](int it) {
    int kt, c;
    step_of(it, kt, c);
    const int j1 = kt * kCols;
    Elem* d = reinterpret_cast<Elem*>(ring + (it % L.ns) * L.stage);
    if (c < L.nslab) {
      const int c0 = c * L.SW, w = min(L.SW, L.Dp - c0);
      if (!L.res) {
        stage_cols<RAGGED>(d, lsS, qb, kRows, B.Wb - B.i0, c0, w, hd);
        stage_cols<RAGGED>(d + kRows * lsS, lsS, ob, kRows, B.Wb - B.i0, c0, w, hd);
        d += 2 * kRows * lsS;
      }
      stage_cols<RAGGED>(d, lsS, kb.from(j1), kCols, B.Wb - j1, c0, w, hd);
      stage_cols<RAGGED>(d + kCols * lsS, lsS, vb.from(j1), kCols, B.Wb - j1, c0, w, hd);
    } else {
      stage_cols<RAGGED>(d, lsC, kb.from(j1), kCols, B.Wb - j1, B.cg * L.CW, L.CW, hd);
    }
  };
  if (L.res) {
    stage_cols<RAGGED>(qres, lsD, qb, kRows, B.Wb - B.i0, 0, L.Dp, hd);
    stage_cols<RAGGED>(ores, lsD, ob, kRows, B.Wb - B.i0, 0, L.Dp, hd);
  }
  for (int i = 0; i < L.ns - 1; ++i) {   // the ring's first stages, a commit group each
    if (i < steps) stage(i);
    k1::cp_async_commit();
  }

  float dqa[kHalfTiles][4] = {};
  float sd[2][2][4];   // s, dp
  float(&s)[2][4] = sd[0];
  float(&dp)[2][4] = sd[1];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    if (it + L.ns - 1 < steps) stage(it + L.ns - 1);
    k1::cp_async_commit();
    ring_wait(L.ns);
    __syncthreads();
    K1_PHASE(0);
    const Elem* st = reinterpret_cast<const Elem*>(ring + (it % L.ns) * L.stage);
    int kt, c;
    step_of(it, kt, c);
    const bool first = it < sweep1;
    const int j0 = kt * kCols + ch * 16;
    int xb, xe, pb, pe;
    tiles_in(wlo, whi, j0, 2, xb, xe);
    tiles_in(wlo, whi, kt * kCols, 4, pb, pe);
    if (it == sweep1) {   // merge the halves: each row's max, 1 / l and D
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + 8 * h;
        const float m0 = red[r], m1 = red[kRows + r];
        const float mm = fmaxf(m0, m1), ms = mm == -INFINITY ? 0.f : mm;
        const float f0 = __expf(m0 - ms), f1 = __expf(m1 - ms);
        const float lt = red[2 * kRows + r] * f0 + red[3 * kRows + r] * f1;
        const float dt = red[4 * kRows + r] * f0 + red[5 * kRows + r] * f1;
        m[h] = ms;
        il[h] = lt > 0.f ? 1.f / lt : 0.f;
        Dr[h] = dt * il[h];
        if (B.cg == 0 && ch == 0 && t == 0 && ra + 8 * h < B.Wb) {
          const size_t at = (size_t)(B.gbase + ra + 8 * h);
          stats[at] = mm;
          stats[positions + at] = il[h];
          stats[2 * positions + at] = Dr[h];
        }
      }
    }
    if (c == 0) {
      zero2(s);
      zero2(dp);
    }
    if (c < L.nslab) {
      const Elem* X = L.res ? qres + (rg * 16) * lsD + c * L.SW : st + (rg * 16) * lsS;
      const Elem* Xo =
          L.res ? ores + (rg * 16) * lsD + c * L.SW : st + (kRows + rg * 16) * lsS;
      const Elem* Y = st + (L.res ? 0 : 2 * kRows * lsS) + (ch * 16) * lsS;
      const Elem* xs[2] = {X, Xo};
      const Elem* ys[2] = {Y, Y + kCols * lsS};
      mma_nt<2, 1>(sd, xs, L.res ? lsD : lsS, ys, lsS, min(L.SW, L.Dp - c * L.SW), lane, xb,
                   xe);
      K1_PHASE(1);
    }
    if (c == L.nslab - 1) {   // the tile's logits and dp are whole
      unsigned keep = 0u;
      if (dropout) {   // sweep 2 reads sweep 1's bits where it kept them
        unsigned char* kb = kbits + kt * kThreads + threadIdx.x;
        keep = !first && kt < kKeepTiles ? *kb : keep_mask(R, j0, 1, thresh, lane);
        if (first && kt < kKeepTiles) *kb = (unsigned char)keep;
      }
      bool ok[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Row& r = R[e >> 1];
          const int j = j0 + 8 * x + 2 * t + (e & 1);
          ok[x][e] = j >= r.lo && j < r.hi;
          s[x][e] = ok[x][e] ? s[x][e] * scale + __ldg(bias + r.cb + j) : -INFINITY;
          if (dropout) dp[x][e] = (keep >> (4 * x + e)) & 1u ? dp[x][e] * inv_keep : 0.f;
        }
      if (first) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[x][e]);
        float ms[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = k1::quad_max(mx[h]);
          ms[h] = mx[h] == -INFINITY ? 0.f : mx[h];
          const float corr = __expf(m[h] - ms[h]);
          m[h] = mx[h];
          l[h] *= corr;
          dn[h] *= corr;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[x][e] - ms[e >> 1]);
            l[e >> 1] += p;
            dn[e >> 1] = fmaf(p, dp[x][e], dn[e >> 1]);
          }
        if (kt == nk - 1) {   // the half's sums go to `red`, merged at step sweep1
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float lq = k1::quad_sum(l[h]), dq_ = k1::quad_sum(dn[h]);
            if (t == 0) {
              const int r = lr + 8 * h;
              red[ch * kRows + r] = m[h];
              red[(2 + ch) * kRows + r] = lq;
              red[(4 + ch) * kRows + r] = dq_;
            }
          }
        }
      } else {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float p = __expf(s[x][e] - m[h]) * il[h];
            s[x][e] = ok[x][e] ? p * (dp[x][e] - Dr[h]) * scale : 0.f;   // ds
          }
        put_half(xd, s, lr, ch, lane);
      }
      K1_PHASE(2);
      if (!first && L.merged) {
        __syncthreads();
        float pf[4][4];
        load_tile(pf, xd, lr, lane);
        mma_pv<kHalfTiles>(dqa, pf, st + oc0, lsS, lane, nact, pb, pe);
      }
    } else if (!first && c == L.nslab) {   // k's group
      float pf[4][4];
      load_tile(pf, xd, lr, lane);
      mma_pv<kHalfTiles>(dqa, pf, st + ch * HW, lsC, lane, nact, pb, pe);
    }
    K1_PHASE(3);
    __syncthreads();
  }
  const k1::Strided rgrad = k1::block_rows<false>(hd, k1::kGrad, (unsigned)B.gbase);
  store_cols<Elem, kHalfTiles, RAGGED>(dq, rgrad, dqa, ra, B.Wb, 1.f, 1.f, lane, hd, oc0, nact);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

// The dk / dv kernel: block (super-window tile, column group) owns 64 keys with their k
// and v. Per query tile qi, steps (qi, c < nslab) add k_c q_c^T and v_c dout_c^T to the
// warp's (16 keys, 16 queries) tiles (step (qi, 0) also stages the 32 queries'
// statistics); after the last slab the warp forms p_drop^T and ds^T (as k1_bwd_mma_dkv)
// into the two exchange tiles; then each warp adds p_drop^T dout to its dv columns and
// ds^T q to its dk columns (in the same step if merged, else in steps (qi, nslab) and
// (qi, nslab + 1), which stage dout's and q's group).
template <typename Elem, bool RAGGED>
__global__ void __launch_bounds__(kw::kThreads)
k1_bwd_wide_dkv(const Elem* __restrict__ q, const Elem* __restrict__ k,
                const Elem* __restrict__ v, const float* __restrict__ bias,
                const Elem* __restrict__ dout, Elem* __restrict__ dk, Elem* __restrict__ dv,
                const float* __restrict__ stats, int S, int W, int Dh, int nwin, int G,
                int tiles, kw::Layout L, size_t positions, float scale,
                const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
                float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace kw;
  constexpr int E = (int)sizeof(Elem);
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const int lsD = L.Dp + 16 / E, lsS = L.SW + 16 / E, lsC = L.CW + 16 / E;
  Elem* kres = reinterpret_cast<Elem*>(sm);   // k rows, then v rows (L.res)
  Elem* vres = kres + kRows * lsD;
  char* ring = sm + (L.res ? 2 * kRows * row_bytes(L.Dp, E) : 0);
  float* xp = reinterpret_cast<float*>(ring + L.ns * L.stage);   // (kRows, kXS) p_drop^T
  float* xd = xp + kRows * kXS;                                 // (kRows, kXS) ds^T
  // 3 x (3, kCols) statistics: a query tile's go in buffer qi % 3, staged up to two steps
  // (two tiles, where a tile is one step) before the tile reads them
  float* sts = xd + kRows * kXS;

  const Block B = block_of(nwin, W, G, tiles, L.groups, causal, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, lr = rg * 16 + (lane >> 2), ja = B.i0 + lr;
  // the block's rows: past kWinMax a block holds one window's tile, one run
  const k1::Strided rin = k1::block_rows<false>(hd, k1::kIn, (unsigned)B.gbase);
  using RO = k1::Strided;
  const k1::Strided rout = k1::block_rows<false>(hd, k1::kOut, (unsigned)B.gbase);
  const Src<Elem, RO> kb{k, rin.from(B.i0)}, vb{v, rin.from(B.i0)}, qb{q, rin}, ob{dout, rout};
  K1_PHASE_BEGIN();
  const Row R[2] = {
      row_of(ja, B.Wb, W, B.gbase, S, causal, true, seed_ptr, group_rows, dropout),
      row_of(ja + 8, B.Wb, W, B.gbase, S, causal, true, seed_ptr, group_rows, dropout)};
  int wlo, whi, blo, bhi;   // the queries the warp's keys and the block's keys reach
  reach(B.i0 + rg * 16, 16, B.Wb, W, causal, true, wlo, whi);
  reach(B.i0, kRows, B.Wb, W, causal, true, blo, bhi);
  const int q0 = blo / kCols, nq = bhi > blo ? cdiv(bhi, kCols) - q0 : 0;
  const int per = L.nslab + (L.merged ? 0 : 2), steps = nq * per;
  const int HW = L.CW / 2, oc0 = B.cg * L.CW + ch * HW;
  const int nact = max(0, min(HW, L.Dp - oc0)) / 8;

  // a slab stage: [k, v slabs (kRows rows each) unless resident] q, dout slabs (kCols)
  const auto stage = [&](int it) {
    const int qi = q0 + it / per, c = it % per, i1 = qi * kCols;
    Elem* d = reinterpret_cast<Elem*>(ring + (it % L.ns) * L.stage);
    if (c < L.nslab) {
      const int c0 = c * L.SW, w = min(L.SW, L.Dp - c0);
      if (!L.res) {
        stage_cols<RAGGED>(d, lsS, kb, kRows, B.Wb - B.i0, c0, w, hd);
        stage_cols<RAGGED>(d + kRows * lsS, lsS, vb, kRows, B.Wb - B.i0, c0, w, hd);
        d += 2 * kRows * lsS;
      }
      stage_cols<RAGGED>(d, lsS, qb.from(i1), kCols, B.Wb - i1, c0, w, hd);
      stage_cols<RAGGED>(d + kCols * lsS, lsS, ob.from(i1), kCols, B.Wb - i1, c0, w, hd);
      if (c == 0) {
        float* sd = sts + (qi % 3) * 3 * kCols;
        for (int e = threadIdx.x; e < 3 * kCols; e += kThreads) {
          const int a = e / kCols, i = e - a * kCols;
          const bool ok = i1 + i < B.Wb;
          k1::cp_async4_zfill(sd + e, ok ? stats + a * positions + B.gbase + i1 + i : stats,
                              ok);
        }
      }
    } else {
      const Src<Elem, RO> src = c == L.nslab ? ob : qb;   // dout's group for dv, then q's for dk
      stage_cols<RAGGED>(d, lsC, src.from(i1), kCols, B.Wb - i1, B.cg * L.CW, L.CW, hd);
    }
  };
  // launched as the dq kernel's dependent: nothing it wrote is read before it has ended
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (L.res) {
    stage_cols<RAGGED>(kres, lsD, kb, kRows, B.Wb - B.i0, 0, L.Dp, hd);
    stage_cols<RAGGED>(vres, lsD, vb, kRows, B.Wb - B.i0, 0, L.Dp, hd);
  }
  for (int i = 0; i < L.ns - 1; ++i) {   // the ring's first stages, a commit group each
    if (i < steps) stage(i);
    k1::cp_async_commit();
  }

  float dka[kHalfTiles][4] = {}, dva[kHalfTiles][4] = {};
  float sd[2][2][4];   // s^T, dp^T
  float(&s)[2][4] = sd[0];
  float(&dp)[2][4] = sd[1];
  for (int it = 0; it < steps; ++it) {
    if (it + L.ns - 1 < steps) stage(it + L.ns - 1);
    k1::cp_async_commit();
    ring_wait(L.ns);
    __syncthreads();
    K1_PHASE(0);
    const Elem* st = reinterpret_cast<const Elem*>(ring + (it % L.ns) * L.stage);
    const int qi = q0 + it / per, c = it % per, i0 = qi * kCols + ch * 16;
    int xb, xe, pb, pe;   // the warp's query tiles of its half, and of the whole tile
    tiles_in(wlo, whi, i0, 2, xb, xe);
    tiles_in(wlo, whi, qi * kCols, 4, pb, pe);
    const Elem* qs = st + (L.res ? 0 : 2 * kRows * lsS);   // the slab's q, then dout
    if (c == 0) {
      zero2(s);
      zero2(dp);
    }
    if (c < L.nslab) {
      const Elem* X = L.res ? kres + (rg * 16) * lsD + c * L.SW : st + (rg * 16) * lsS;
      const Elem* Xv =
          L.res ? vres + (rg * 16) * lsD + c * L.SW : st + (kRows + rg * 16) * lsS;
      const int lx = L.res ? lsD : lsS, kc = min(L.SW, L.Dp - c * L.SW);
      const Elem* xs[2] = {X, Xv};
      const Elem* ys[2] = {qs + (ch * 16) * lsS, qs + (kCols + ch * 16) * lsS};
      if constexpr (sizeof(Elem) == 4) {
        mma_nt<2, 1>(sd, xs, lx, ys, lsS, kc, lane, xb, xe);
      } else {   // in bf16 one product at a time: two at once spill beside dk and dv
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          const Elem* x1[1] = {xs[pr]};
          const Elem* y1[1] = {ys[pr]};
          mma_nt<1, 1>(reinterpret_cast<float(&)[1][2][4]>(sd[pr]), x1, lx, y1, lsS, kc, lane,
                       xb, xe);
        }
      }
      K1_PHASE(1);
    }
    if (c == L.nslab - 1) {   // s^T and dp^T of the tile are whole
      const float* sq = sts + (qi % 3) * 3 * kCols;
      const unsigned keep = dropout ? keep_mask<false>(R, i0, S, thresh, lane) : 0u;
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Row& r = R[e >> 1];
          const int li = ch * 16 + 8 * x + 2 * t + (e & 1), i = qi * kCols + li;
          float p = 0.f, ds = 0.f;
          if (i >= r.lo && i < r.hi) {
            const float y = s[x][e] * scale + __ldg(bias + r.cb + (long long)i * S);
            p = __expf(y - sq[li]) * sq[kCols + li];
            const bool kept = !dropout || ((keep >> (4 * x + e)) & 1u);
            const float g = !dropout ? dp[x][e] : kept ? dp[x][e] * inv_keep : 0.f;
            ds = p * (g - sq[2 * kCols + li]) * scale;
            p = !dropout ? p : kept ? p * inv_keep : 0.f;
          }
          s[x][e] = p;
          dp[x][e] = ds;
        }
      put_half(xp, s, lr, ch, lane);
      put_half(xd, dp, lr, ch, lane);
      K1_PHASE(2);
      if (L.merged) {
        __syncthreads();
        float pf[4][4];
        load_tile(pf, xp, lr, lane);
        mma_pv<kHalfTiles>(dva, pf, qs + kCols * lsS + oc0, lsS, lane, nact, pb, pe);
        load_tile(pf, xd, lr, lane);
        mma_pv<kHalfTiles>(dka, pf, qs + oc0, lsS, lane, nact, pb, pe);
      }
    } else if (c == L.nslab) {   // dout's group: dv
      float pf[4][4];
      load_tile(pf, xp, lr, lane);
      mma_pv<kHalfTiles>(dva, pf, st + ch * HW, lsC, lane, nact, pb, pe);
    } else if (c == L.nslab + 1) {   // q's group: dk
      float pf[4][4];
      load_tile(pf, xd, lr, lane);
      mma_pv<kHalfTiles>(dka, pf, st + ch * HW, lsC, lane, nact, pb, pe);
    }
    K1_PHASE(3);
    __syncthreads();
  }
  const k1::Strided rgrad = k1::block_rows<false>(hd, k1::kGrad, (unsigned)B.gbase);
  store_cols<Elem, kHalfTiles, RAGGED>(dv, rgrad, dva, ja, B.Wb, 1.f, 1.f, lane, hd, oc0, nact);
  store_cols<Elem, kHalfTiles, RAGGED>(dk, rgrad, dka, ja, B.Wb, 1.f, 1.f, lane, hd, oc0, nact);
  K1_PHASE(3);
  K1_PHASE_END(1);
}

// The one-kernel backward at W <= kWinMax: block (super-window, column group) holds whole
// windows, so it owns every output of its 64 rows, as queries (dq) and as keys (dk, dv).
// Steps c < nslab stage slab c of the rows' q, dout, k and v and add to the warp's (16, 16)
// logits and dout v^T of both 32-key tiles (key half ch of each); after the last, the warps
// put s (scale and bias added, -inf where the pair is outside the window or above a causal
// diagonal), dp (the keep factor applied) and the keep bits into the (64, 64) tiles; then
// each warp takes 8 whole rows through the softmax (max, l and D = sum p dp over the row's
// 64 keys, in a fixed butterfly order) and leaves p_drop and ds in the tiles. Six steps
// follow, each staging 32 rows of one tensor's group columns: dq = ds k, dk = ds^T q and
// dv = p_drop^T dout, each over the 64 keys (queries) in two halves, stored after its
// second. Two products over the whole head dim and three over the group's columns a pair,
// one launch, nothing between kernels in device memory.
template <typename Elem, bool RAGGED, bool SPAN>
__global__ void __launch_bounds__(kw::kThreads, sizeof(Elem) == 4 ? 2 : 1)
k1_bwd_wide_win(const Elem* __restrict__ q, const Elem* __restrict__ k,
                const Elem* __restrict__ v, const float* __restrict__ bias,
                const Elem* __restrict__ dout, Elem* __restrict__ dq, Elem* __restrict__ dk,
                Elem* __restrict__ dv, int S, int W, int Dh, int nwin, int G, kw::Layout L,
                float scale, const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
                float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace kw;
  constexpr int E = (int)sizeof(Elem);
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  float* ts = reinterpret_cast<float*>(ring + L.ns * L.stage);   // (kRows, kWS) s, p_drop
  float* tp = ts + kRows * kWS;                                 // (kRows, kWS) dp, ds
  unsigned char* kp = reinterpret_cast<unsigned char*>(tp + kRows * kWS);   // keep bytes
  const int lsS = L.SW + 16 / E, lsC = L.CW + 16 / E;

  const Block B = block_of(nwin, W, G, 1, L.groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rg = warp & 3, ch = warp >> 2, lr = rg * 16 + (lane >> 2);
  const auto rin = k1::block_rows<SPAN>(hd, k1::kIn, (unsigned)B.gbase);   // the block's rows
  using RO = std::decay_t<decltype(rin)>;
  const auto rout = k1::block_rows<SPAN>(hd, k1::kOut, (unsigned)B.gbase);
  const Src<Elem, RO> src[4] = {{q, rin}, {dout, rout}, {k, rin}, {v, rin}};
  K1_PHASE_BEGIN();
  const Row R[2] = {
      row_of(lr, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout),
      row_of(lr + 8, B.Wb, W, B.gbase, S, causal, false, seed_ptr, group_rows, dropout)};
  int qlo, qhi, klo, khi;   // the keys the warp's rows reach as queries; the queries as keys
  reach(rg * 16, 16, B.Wb, W, causal, false, qlo, qhi);
  reach(rg * 16, 16, B.Wb, W, causal, true, klo, khi);
  const int steps = L.nslab + 6;
  const int HW = L.CW / 2, oc0 = B.cg * L.CW + ch * HW;
  const int nact = max(0, min(HW, L.Dp - oc0)) / 8;

  // slab c: the 64 rows of q, dout, k, v; then product p (dq: k; dk: q; dv: dout), half hb
  const auto stage = [&](int it) {
    Elem* d = reinterpret_cast<Elem*>(ring + (it % L.ns) * L.stage);
    if (it < L.nslab) {
      const int c0 = it * L.SW, w = min(L.SW, L.Dp - c0);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        stage_cols<RAGGED>(d + a * kRows * lsS, lsS, src[a], kRows, B.Wb, c0, w, hd);
    } else {
      const int p = (it - L.nslab) >> 1, hb = (it - L.nslab) & 1;
      const Src<Elem, RO> b = src[p == 0 ? 2 : p == 1 ? 0 : 1].from(hb * kCols);
      stage_cols<RAGGED>(d, lsC, b, kCols, B.Wb - hb * kCols, B.cg * L.CW, L.CW, hd);
    }
  };
  for (int i = 0; i < L.ns - 1; ++i) {   // the ring's first stages, a commit group each
    if (i < steps) stage(i);
    k1::cp_async_commit();
  }

  float sd[2][2][2][4] = {};   // key tile, (s, dp), column tile
  for (int it = 0; it < L.nslab; ++it) {
    if (it + L.ns - 1 < steps) stage(it + L.ns - 1);
    k1::cp_async_commit();
    ring_wait(L.ns);
    __syncthreads();
    K1_PHASE(0);
    const Elem* st = reinterpret_cast<const Elem*>(ring + (it % L.ns) * L.stage);
    const int kc = min(L.SW, L.Dp - it * L.SW);
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      int xb, xe;
      tiles_in(qlo, qhi, kt * kCols + ch * 16, 2, xb, xe);
      const Elem* xs[2] = {st + (rg * 16) * lsS, st + (kRows + rg * 16) * lsS};
      const Elem* ys[2] = {st + (2 * kRows + kt * kCols + ch * 16) * lsS,
                           st + (3 * kRows + kt * kCols + ch * 16) * lsS};
      mma_nt<2, 1>(sd[kt], xs, lsS, ys, lsS, kc, lane, xb, xe);
    }
    K1_PHASE(1);
    __syncthreads();
  }
  // the logits and dp are whole: into the tiles
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const int j0 = kt * kCols + ch * 16;
    const unsigned keep = dropout ? keep_mask(R, j0, 1, thresh, lane) : 0u;
    float(&s)[2][4] = sd[kt][0];
    float(&dp)[2][4] = sd[kt][1];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Row& r = R[e >> 1];
        const int j = j0 + 8 * x + 2 * t + (e & 1);
        const bool ok = j >= r.lo && j < r.hi;
        const bool kept = !dropout || ((keep >> (4 * x + e)) & 1u);
        s[x][e] = ok ? s[x][e] * scale + __ldg(bias + r.cb + j) : -INFINITY;
        dp[x][e] = !ok ? 0.f : !dropout ? dp[x][e] : kept ? dp[x][e] * inv_keep : 0.f;
        kp[(lr + 8 * (e >> 1)) * kRows + j] = ok && kept;
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int j = j0 + 8 * x + 2 * t;
      *reinterpret_cast<float2*>(ts + lr * kWS + j) = make_float2(s[x][0], s[x][1]);
      *reinterpret_cast<float2*>(ts + (lr + 8) * kWS + j) = make_float2(s[x][2], s[x][3]);
      *reinterpret_cast<float2*>(tp + lr * kWS + j) = make_float2(dp[x][0], dp[x][1]);
      *reinterpret_cast<float2*>(tp + (lr + 8) * kWS + j) = make_float2(dp[x][2], dp[x][3]);
    }
  }
  __syncthreads();
  // rows 8 warp .. 8 warp + 7, keys 2 lane and 2 lane + 1 of each
#pragma unroll 1
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const float2 sv = *reinterpret_cast<const float2*>(ts + r * kWS + 2 * lane);
    const float2 gv = *reinterpret_cast<const float2*>(tp + r * kWS + 2 * lane);
    const float mm = k1::lanes_max<32>(fmaxf(sv.x, sv.y)), ms = mm == -INFINITY ? 0.f : mm;
    const float e0 = __expf(sv.x - ms), e1 = __expf(sv.y - ms);
    const float l = k1::lanes_sum<32>(e0 + e1), il = l > 0.f ? 1.f / l : 0.f;
    const float Dr = k1::lanes_sum<32>(fmaf(e0, gv.x, e1 * gv.y)) * il;
    const float p0 = e0 * il, p1 = e1 * il;
    const unsigned char* kr = kp + r * kRows + 2 * lane;
    const float f0 = !dropout ? 1.f : kr[0] ? inv_keep : 0.f;
    const float f1 = !dropout ? 1.f : kr[1] ? inv_keep : 0.f;
    *reinterpret_cast<float2*>(ts + r * kWS + 2 * lane) = make_float2(p0 * f0, p1 * f1);
    *reinterpret_cast<float2*>(tp + r * kWS + 2 * lane) =
        make_float2(p0 * (gv.x - Dr) * scale, p1 * (gv.y - Dr) * scale);
  }
  K1_PHASE(2);
  // product p, inner half hb: dq = ds k, dk = ds^T q, dv = p_drop^T dout
  float acc[kHalfTiles][4] = {};
  for (int it = L.nslab; it < steps; ++it) {
    if (it + L.ns - 1 < steps) stage(it + L.ns - 1);
    k1::cp_async_commit();
    ring_wait(L.ns);
    __syncthreads();
    K1_PHASE(0);
    const Elem* st = reinterpret_cast<const Elem*>(ring + (it % L.ns) * L.stage);
    const int p = (it - L.nslab) >> 1, hb = (it - L.nslab) & 1;
    int pb, pe;
    if (p == 0)
      tiles_in(qlo, qhi, hb * kCols, 4, pb, pe);
    else
      tiles_in(klo, khi, hb * kCols, 4, pb, pe);
    float pf[4][4];
    if (p == 0) {
      const float* a = tp + lr * kWS + hb * kCols + 2 * t;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pf[x][0] = a[8 * x], pf[x][1] = a[8 * x + 1];
        pf[x][2] = a[8 * kWS + 8 * x], pf[x][3] = a[8 * kWS + 8 * x + 1];
      }
    } else {   // transposed: the warp's rows are keys, the tile's columns queries
      const float* a = (p == 1 ? tp : ts) + (hb * kCols + 2 * t) * kWS + lr;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pf[x][0] = a[8 * x * kWS], pf[x][1] = a[(8 * x + 1) * kWS];
        pf[x][2] = a[8 * x * kWS + 8], pf[x][3] = a[(8 * x + 1) * kWS + 8];
      }
    }
    mma_pv<kHalfTiles>(acc, pf, st + ch * HW, lsC, lane, nact, pb, pe);
    K1_PHASE(3);
    if (hb == 1) {
      Elem* out = p == 0 ? dq : p == 1 ? dk : dv;
      store_cols<Elem, kHalfTiles, RAGGED>(out,
                                           k1::block_rows<SPAN>(hd, k1::kGrad, (unsigned)B.gbase),
                                           acc, lr, B.Wb, 1.f, 1.f, lane, hd, oc0, nact);
#pragma unroll
      for (int n = 0; n < kHalfTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    __syncthreads();
  }
  K1_PHASE_END(0);
}

// The launch plan's numbers (ops/attention.py::wide_plan); the caller's must equal them.
// The rows' layout and `copy` as k1_tiles.cuh's launch_head: under 16 the RAGGED forms run.
inline bool wide_shape(int BH, int S, int W, int Dh, int group_rows, int dropout,
                       const int* seed) {
  return !(dropout && seed == nullptr) && W >= 1 && S % W == 0 && S <= k1::kMaxRow &&
         group_rows >= 1 && BH % group_rows == 0 && Dh > 128;
}

constexpr int kWidePath = 2;   // ops/attention.py PATH_CODE["wide"]

template <typename Elem, bool RAGGED>
int launch_wide_fwd(const Elem* q, const Elem* k, const Elem* v, const float* bias, Elem* out,
                    int S, int W, int Dh, long long nwin, const kw::Grid& g, const kw::Layout& L,
                    float scale, const int* seed, int group_rows, unsigned thresh,
                    float inv_keep, int dropout, int causal, int blocks,
                    const k1::Head& hd, cudaStream_t st) {
  const auto kernel = k1::spans_rows(hd, g.G * W) ? k1_fwd_wide<Elem, RAGGED, true>
                                                   : k1_fwd_wide<Elem, RAGGED, false>;
  const cudaError_t e = k1::allow_smem(kernel, L.smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, kw::kThreads, L.smem, st>>>(
      q, k, v, bias, out, S, W, Dh, (int)nwin, g.G, g.tiles, L, scale, seed, group_rows, thresh,
      inv_keep, dropout, causal, hd);
  return (int)cudaGetLastError();
}

// A library holds one form, as k1_fwd.cuh's: kRagged takes copies under 16 bytes.
template <bool kRagged, typename Elem>
int dispatch_wide_fwd(const Elem* q, const Elem* k, const Elem* v, const float* bias, Elem* out,
                      int BH, int S, int W, int Dh, int H, long long in_pos, long long in_batch,
                      long long out_pos, long long out_batch, float scale, const int* seed,
                      int group_rows, unsigned thresh, float inv_keep, int dropout, int causal,
                      int path, int blocks, int smem_bytes, int copy, void* stream) {
  k1::Head hd;
  if (!wide_shape(BH, S, W, Dh, group_rows, dropout, seed) ||
      !k1::launch_head(BH, S, Dh, copy, (int)sizeof(Elem), H, in_pos, in_batch, out_pos,
                       out_batch, 0, 0, {q, k, v, out}, hd))
    return (int)cudaErrorInvalidValue;
  const long long nwin = (long long)BH * (S / W);
  const kw::Grid g = kw::grid_of(nwin, W, Dh);
  const kw::Layout L = kw::layout(Dh, (int)sizeof(Elem), kw::kFwd, g.groups);
  if (path != kWidePath || L.smem == 0 || g.blocks != (long long)blocks ||
      smem_bytes != L.smem)
    return (int)cudaErrorInvalidValue;
  if ((copy < 16) != kRagged) return (int)cudaErrorInvalidValue;
  return launch_wide_fwd<Elem, kRagged>(q, k, v, bias, out, S, W, Dh, nwin, g, L, scale, seed,
                                        group_rows, thresh, inv_keep, dropout, causal, blocks,
                                        hd, (cudaStream_t)stream);
}

template <typename Elem, bool RAGGED>
int launch_wide_bwd(const Elem* q, const Elem* k, const Elem* v, const float* bias,
                    const Elem* dout, Elem* dq, Elem* dk, Elem* dv, float* stats, int BH,
                    int S, int W, int Dh, long long nwin, const kw::Grid& g, float scale,
                    const int* seed, int group_rows, unsigned thresh, float inv_keep,
                    int dropout, int causal, int path, int blocks, int smem_bytes,
                    int blocks_kv, int smem_kv, const k1::Head& hd, cudaStream_t st) {
  if (W <= kw::kWinMax) {   // one kernel
    const kw::Layout L = kw::win_layout(Dh, (int)sizeof(Elem), g.groups);
    if (path != kWidePath || L.smem == 0 || g.blocks != (long long)blocks || blocks_kv != 0 ||
        smem_kv != 0 || smem_bytes != L.smem)
      return (int)cudaErrorInvalidValue;
    const auto kernel = k1::spans_rows(hd, g.G * W) ? k1_bwd_wide_win<Elem, RAGGED, true>
                                                     : k1_bwd_wide_win<Elem, RAGGED, false>;
    const cudaError_t e = k1::allow_smem(kernel, L.smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, kw::kThreads, L.smem, st>>>(
        q, k, v, bias, dout, dq, dk, dv, S, W, Dh, (int)nwin, g.G, L, scale, seed, group_rows,
        thresh, inv_keep, dropout, causal, hd);
    return (int)cudaGetLastError();
  }
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  const kw::Layout L = kw::layout(Dh, (int)sizeof(Elem), kw::kDq, g.groups);
  const kw::Layout L2 = kw::layout(Dh, (int)sizeof(Elem), kw::kDkv, g.groups);
  if (path != kWidePath || L.smem == 0 || L2.smem == 0 || g.blocks != (long long)blocks ||
      blocks_kv != blocks || smem_bytes != L.smem || smem_kv != L2.smem)
    return (int)cudaErrorInvalidValue;
  const size_t positions = (size_t)BH * S;
  cudaError_t e = k1::allow_smem(k1_bwd_wide_dq<Elem, RAGGED>, L.smem);
  if (e != cudaSuccess) return (int)e;
  k1_bwd_wide_dq<Elem, RAGGED><<<blocks, kw::kThreads, L.smem, st>>>(
      q, k, v, bias, dout, dq, stats, S, W, Dh, (int)nwin, g.G, g.tiles, L, positions, scale,
      seed, group_rows, thresh, inv_keep, dropout, causal, hd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = k1::allow_smem(k1_bwd_wide_dkv<Elem, RAGGED>, L2.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_kv);
  cfg.blockDim = dim3(kw::kThreads);
  cfg.dynamicSmemBytes = L2.smem;
  cfg.stream = st;
  cfg.attrs = dep;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k1_bwd_wide_dkv<Elem, RAGGED>, q, k, v, bias, dout, dk, dv,
                         (const float*)stats, S, W, Dh, (int)nwin, g.G, g.tiles, L2, positions,
                         scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool kRagged, typename Elem>
int dispatch_wide_bwd(const Elem* q, const Elem* k, const Elem* v, const float* bias,
                      const Elem* dout, Elem* dq, Elem* dk, Elem* dv, float* stats, int BH,
                      int S, int W, int Dh, int H, long long in_pos, long long in_batch,
                      long long out_pos, long long out_batch, long long grad_pos,
                      long long grad_batch, float scale, const int* seed, int group_rows,
                      unsigned thresh, float inv_keep, int dropout, int causal, int path,
                      int blocks, int smem_bytes, int blocks_kv, int smem_kv, int copy,
                      void* stream) {
  k1::Head hd;
  if (!wide_shape(BH, S, W, Dh, group_rows, dropout, seed) ||
      !k1::launch_head(BH, S, Dh, copy, (int)sizeof(Elem), H, in_pos, in_batch, out_pos,
                       out_batch, grad_pos, grad_batch, {q, k, v, dout, dq, dk, dv}, hd))
    return (int)cudaErrorInvalidValue;
  const long long nwin = (long long)BH * (S / W);
  const kw::Grid g = kw::grid_of(nwin, W, Dh);
  if ((copy < 16) != kRagged) return (int)cudaErrorInvalidValue;
  return launch_wide_bwd<Elem, kRagged>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, Dh,
                                        nwin, g, scale, seed, group_rows, thresh, inv_keep,
                                        dropout, causal, path, blocks, smem_bytes, blocks_kv,
                                        smem_kv, hd, (cudaStream_t)stream);
}

}  // namespace
