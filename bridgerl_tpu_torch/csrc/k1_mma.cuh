// Shared pieces of K1's long-window path (k1_fwd.cuh and k1_bwd.cuh):
// windows of W >= kMinWindow positions, on the tensor cores through
// mma.sync.
//
// A block owns kRows = 64 rows of one window (queries in the forward and in
// the dq kernel, keys in the dk / dv kernel), 16 rows a warp, and streams
// the window's other side through shared memory in tiles of kCols = 32 rows,
// double-buffered with cp.async (k1_tiles.cuh's 16-byte copies; rows past
// the window are zero-filled). A warp's products are (16 x 8) accumulator
// tiles of mma.sync, float32 accumulators in registers:
//   bfloat16: m16n8k16 with bf16 operands. q, k, v and dout are bf16 in
//     device memory and staged as they are, so q k^T and dout v^T are exact
//     products. A float32 operand (p, ds) is split into three bf16 parts,
//     hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), and takes
//     three products against the exact bf16 right operand, so it keeps all
//     24 bits of its mantissa: the bf16 outputs stay within one ulp of the
//     plain version's even where a sum cancels to near 0 (two parts keep 16
//     bits, and miss that rule by a few ulps on such outputs).
//   float32: m16n8k8 with tf32 operands, three products a tile (3xTF32:
//     hi * hi + hi * lo + lo * hi, hi and lo the top bits of x and of
//     x - hi), which keeps about 20 bits: float32's 1e-4 agreement holds;
//     plain TF32's 10 bits would not.
// The accumulator layout of both shapes is the same: lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 2t and 2t + 1 of each tile.
// The softmax, the bias, the masks and the Philox draws work on that layout,
// so (i, j) of every element is known where it is computed. A product whose
// left operand is such a register tile (p v, ds k, p^T dout, ds^T q) takes
// it without a trip through shared memory: in bf16 two adjacent column
// tiles are exactly an m16n8k16 A fragment; in tf32 the k index of the
// m16n8k8 A fragment is permuted (k = t holds column 2t, k = t + 4 column
// 2t + 1) and the right operand's rows are read in the same order.
//
// Shared rows are padded by 16 bytes (Dh + 4 floats, Dh + 8 bf16), so the
// fragment loads of one warp, whether they read 8 rows at 4 columns or 4
// row pairs at 8 columns, fall in 32 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "k1_tiles.cuh"
#include "philox.cuh"

// Phase marks of the long-window kernels, empty unless tools/k1_phases.py
// defines them (thread 0 of each block: the time since the last mark goes
// to phase p; 0 staging and waiting, 1 logits, softmax and draws, 2 the
// products from registers, 3 the stores).
#ifndef K1_PHASE
#define K1_PHASE_BEGIN()
#define K1_PHASE(p)
#define K1_PHASE_END(kernel)
#endif

namespace k1 {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRows = 16 * kMmaWarps;  // rows a long-window block owns
constexpr int kCols = 32;              // rows of a streamed tile
constexpr int kMinWindow = 32;         // W*: shorter windows take the window tiles
constexpr int kMaxRow = 65535;         // S: i * S + j must fit the 32-bit Philox counter
// The two-kernel backward takes the row-buffered dq kernel and the keys kernel (blocks of
// kRows / 2) where blocks of kRows would number fewer than kFullGrid, two an SM of the
// H100's 132 (bwd_block_rows).
constexpr int kFullGrid = 264;

template <typename Elem, int DH>
struct MmaTile {
  static constexpr int LS = DH + 16 / (int)sizeof(Elem);  // padded row stride, elements
  static constexpr int CH = DH * (int)sizeof(Elem) / 16;  // 16-byte chunks of a row
};

// Shared memory of each kernel, bytes (ops/attention.py::k1_plan mirrors them).
template <typename Elem, int DH>
constexpr int fwd_mma_smem() {
  return (kRows + 4 * kCols) * MmaTile<Elem, DH>::LS * (int)sizeof(Elem);
}
// The two-sweep dq kernel (full cards, and windows too long for the row buffers below).
template <typename Elem, int DH>
constexpr int bwd_dq_smem() {
  return (2 * kRows + 4 * kCols) * MmaTile<Elem, DH>::LS * (int)sizeof(Elem);
}
// The row-buffered dq kernel of RB rows: q and dout rows, two stages of (K, V) tiles, two
// (RB, bwd_buffer_stride(W)) float32 buffers (logits then ds; dp) and the keep flags, a
// 32-bit word a row and key tile. A buffer row holds the window's keys in whole tiles, and
// 4 more, so that the phases' accesses of consecutive rows fall in other banks.
__host__ __device__ constexpr int bwd_buffer_stride(int W) {
  return (W + kCols - 1) / kCols * kCols + 4;
}
template <typename Elem, int DH>
constexpr long long bwd_rows_smem(int RB, int W) {
  return (long long)(2 * RB + 4 * kCols) * MmaTile<Elem, DH>::LS * (int)sizeof(Elem) +
         8LL * RB * bwd_buffer_stride(W) + 4LL * RB * ((W + kCols - 1) / kCols);
}
// The row stride of the p_drop and ds planes the row-buffered dq kernel writes (W x W
// floats a window each, rows in whole tiles) and the keys kernel reads.
__host__ __device__ constexpr int bwd_plane_stride(int W) {
  return (W + kCols - 1) / kCols * kCols;
}
// The keys kernel: two stages of (q, dout) tiles and of (p_drop, ds) tiles of kCols queries
// by kRows / 2 + 4 floats.
template <typename Elem, int DH>
constexpr int bwd_keys_smem() {
  return 4 * kCols * MmaTile<Elem, DH>::LS * (int)sizeof(Elem) +
         4 * kCols * (kRows / 2 + 4) * (int)sizeof(float);
}
// The dk / dv kernel (with the two-sweep dq kernel) of kRows keys: k and v rows, two stages
// of (q, dout) tiles and of the rows' three statistics.
template <typename Elem, int DH>
constexpr int bwd_cols_smem() {
  return (2 * kRows + 4 * kCols) * MmaTile<Elem, DH>::LS * (int)sizeof(Elem) +
         2 * 3 * kCols * (int)sizeof(float);
}
// The rows of the row-buffered dq kernel's blocks (and the keys of the keys
// kernel's with it): kRows / 2 where blocks of kRows would not fill the card
// (kFullGrid) and the row buffers fit; else 0, and the two-sweep dq kernel
// runs with the dk / dv kernel in blocks of kRows. On a full card the
// two-sweep kernel's small blocks (three an SM) beat the row buffers' (one an
// SM at W 256; PERF.md §6).
template <typename Elem, int DH>
int bwd_block_rows(long long nwin, int W) {
  const bool full = nwin * ((W + kRows - 1) / kRows) >= kFullGrid;
  return !full && bwd_rows_smem<Elem, DH>(kRows / 2, W) <= kSmemLimit ? kRows / 2 : 0;
}
// The window-resident backward: R = 16 NW rows (NW warps) of q, k, v and dout, and one
// (R, R + 4) float32 tile that holds p_drop, then ds. It takes windows of up to kRows
// positions at every head dim, and up to 2 kRows at Dh <= 64 (at Dh 128 the staged rows
// and the tile would not fit, nor a thread's registers); bwd_window_rows is its R, or 0.
template <int DH>
constexpr int bwd_window_rows(int W) {
  return W <= kRows ? kRows : (DH <= 64 && W <= 2 * kRows) ? 2 * kRows : 0;
}
template <typename Elem, int DH>
constexpr int bwd_window_smem(int R) {
  return 4 * R * MmaTile<Elem, DH>::LS * (int)sizeof(Elem) + R * (R + 4) * (int)sizeof(float);
}

// Key tiles a query tile qt of `rows` rows reads (forward, dq): all of the
// window's, or under causal those that reach the block's last query.
__device__ __forceinline__ int key_tiles(int W, int qt, int causal, int rows = kRows) {
  const int n = (W + kCols - 1) / kCols;
  return causal ? min(n, (qt * rows + rows - 1) / kCols + 1) : n;
}
// First query tile a key tile kt of `rows` keys reads (dk / dv): under causal,
// the one that holds the block's first key; every later one runs.
__device__ __forceinline__ int first_query_tile(int kt, int causal, int rows = kRows) {
  return causal ? kt * rows / kCols : 0;
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of `rows` rows of DH elements, row r at src + ro(r) (ragged: rows of
// Dh, the columns from Dh zero-filled), into the padded tile `dst`; rows at or past
// `valid` are zero-filled (nothing is read for them: `safe` is any valid address).
template <typename Elem, int DH, bool RAGGED, typename RO>
__device__ __forceinline__ void stage_mma(Elem* dst, const Elem* src, RO ro, int rows,
                                          int valid, const Elem* safe, const Head& h) {
  constexpr int LS = MmaTile<Elem, DH>::LS, CH = MmaTile<Elem, DH>::CH;
  constexpr int E = 16 / (int)sizeof(Elem);
  if constexpr (RAGGED) {
    stage_ragged(dst, LS, src, ro, rows, valid, 0, DH, h, safe);
  } else {
    for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
      const int r = e / CH, c = e - r * CH;
      const bool ok = r < valid;
      cp_async16_zfill(dst + r * LS + c * E, ok ? src + ro(r) + c * E : safe, ok);
    }
  }
}

// ---- mma.sync and its operands

// x = hi + lo + r: hi keeps the top 10 bits of x's mantissa (truncated), lo
// those of x - hi (exact in float32), so |r| < 2^-20 |x|; both are tf32 bit
// patterns. Three integer and float operations, no conversion instruction.
constexpr unsigned kTf32Mask = 0xffffe000u;
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// (a, b), the lower index in the low half, as three bf16 pairs: x = hi + mid
// + lo to within 2^-24 of x
__device__ __forceinline__ void split3_bf16x2(float a, float b, unsigned (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
    part[i] = pack_bf16(ah, bh);
    a -= __bfloat162float(ah);
    b -= __bfloat162float(bh);
  }
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}


// acc[n] += X[0..16) . Y[8n .. 8n + 8)^T over DH: X the warp's 16 rows of a
// padded tile, Y the streamed tile's rows; both row-major in shared memory.
// 3xTF32 (lo * hi + hi * lo + hi * hi, the small terms first) and the
// bf16 three-part products go through one accumulator a tile; the products
// are issued in groups of kGroup column tiles, each product of a group
// before the next one of the same tile, so that consecutive mma.sync
// instructions do not wait on each other.
constexpr int kGroup = 4;

// Column tiles n_end and later are left as they are (those wholly above a
// causal diagonal).
template <int NT, int DH>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const float* X, const float* Y,
                                        int lane, int n_end = NT) {
  constexpr int LS = MmaTile<float, DH>::LS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* xa = X + g * LS + kk * 8 + t;
    unsigned ah[4], al[4];
    split_tf32(xa[0], ah[0], al[0]);
    split_tf32(xa[8 * LS], ah[1], al[1]);
    split_tf32(xa[4], ah[2], al[2]);
    split_tf32(xa[8 * LS + 4], ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += kGroup) {
      unsigned bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (n0 + u >= NT || n0 + u >= n_end) continue;
        const float* yb = Y + ((n0 + u) * 8 + g) * LS + kk * 8 + t;
        split_tf32(yb[0], bh[u][0], bl[u][0]);
        split_tf32(yb[4], bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NT && n0 + u < n_end) mma_tf32(acc[n0 + u], al, bh[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NT && n0 + u < n_end) mma_tf32(acc[n0 + u], ah, bl[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NT && n0 + u < n_end) mma_tf32(acc[n0 + u], ah, bh[u]);
    }
  }
}

template <int NT, int DH>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const __nv_bfloat16* X,
                                        const __nv_bfloat16* Y, int lane, int n_end = NT) {
  constexpr int LS = MmaTile<__nv_bfloat16, DH>::LS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* xa = X + g * LS + kk * 16 + 2 * t;
    const unsigned a[4] = {ld32(xa), ld32(xa + 8 * LS), ld32(xa + 8), ld32(xa + 8 * LS + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= n_end) continue;
      const __nv_bfloat16* yb = Y + (n * 8 + g) * LS + kk * 16 + 2 * t;
      const unsigned b[2] = {ld32(yb), ld32(yb + 8)};
      mma_bf16(acc[n], a, b);
    }
  }
}

// acc[n] += P . Z[:, 8n .. 8n + 8) for the NO output tiles of 8 columns
// (all of DH's by default; fewer where Z points at a warp's share of the
// columns): P the warp's (16, 8 KT) register tile (accumulator layout), Z the
// streamed tile of 8 KT rows, row-major with DH's padded stride. Only P's
// column tiles k_begin .. k_end - 1 are read (the others are 0: wholly above
// a causal diagonal); in bf16 they are taken in pairs.
template <int KT, int DH, int NO = DH / 8>
__device__ __forceinline__ void gemm_pv(float (&acc)[NO][4], const float (&p)[KT][4],
                                        const float* Z, int lane, int k_begin = 0,
                                        int k_end = KT) {
  constexpr int LS = MmaTile<float, DH>::LS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    if (kt < k_begin || kt >= k_end) continue;
    unsigned ah[4], al[4];
    split_tf32(p[kt][0], ah[0], al[0]);  // row g, column 2t: k = t
    split_tf32(p[kt][2], ah[1], al[1]);  // row g + 8, column 2t
    split_tf32(p[kt][1], ah[2], al[2]);  // row g, column 2t + 1: k = t + 4
    split_tf32(p[kt][3], ah[3], al[3]);  // row g + 8, column 2t + 1
    const float* z = Z + (kt * 8 + 2 * t) * LS + g;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kGroup) {
      unsigned bh[kGroup][2], bl[kGroup][2];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (n0 + u >= NO) continue;
        split_tf32(z[(n0 + u) * 8], bh[u][0], bl[u][0]);       // Z row 2t
        split_tf32(z[LS + (n0 + u) * 8], bh[u][1], bl[u][1]);  // Z row 2t + 1
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NO) mma_tf32(acc[n0 + u], al, bh[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NO) mma_tf32(acc[n0 + u], ah, bl[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (n0 + u < NO) mma_tf32(acc[n0 + u], ah, bh[u]);
    }
  }
}

template <int KT, int DH, int NO = DH / 8>
__device__ __forceinline__ void gemm_pv(float (&acc)[NO][4], const float (&p)[KT][4],
                                        const __nv_bfloat16* Z, int lane, int k_begin = 0,
                                        int k_end = KT) {
  static_assert(KT % 2 == 0, "bf16 products take column tiles in pairs");
  constexpr int LS = MmaTile<__nv_bfloat16, DH>::LS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kp = 0; kp < KT / 2; ++kp) {
    if (2 * kp + 1 < k_begin || 2 * kp >= k_end) continue;
    unsigned a[4][3];   // the A fragment's four registers, three parts each
    split3_bf16x2(p[2 * kp][0], p[2 * kp][1], a[0]);
    split3_bf16x2(p[2 * kp][2], p[2 * kp][3], a[1]);
    split3_bf16x2(p[2 * kp + 1][0], p[2 * kp + 1][1], a[2]);
    split3_bf16x2(p[2 * kp + 1][2], p[2 * kp + 1][3], a[3]);
    const __nv_bfloat16* z = Z + (kp * 16 + 2 * t) * LS + g;
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += kGroup) {
      unsigned b[kGroup][2];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (n0 + u >= NO) continue;
        const int c = (n0 + u) * 8;
        b[u][0] = pack_bf16(z[c], z[LS + c]);
        b[u][1] = pack_bf16(z[8 * LS + c], z[9 * LS + c]);
      }
#pragma unroll
      for (int part = 2; part >= 0; --part) {   // lo, mid, hi
        const unsigned ap[4] = {a[0][part], a[1][part], a[2][part], a[3][part]};
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (n0 + u < NO) mma_bf16(acc[n0 + u], ap, b[u]);
      }
    }
  }
}

// ---- the accumulator layout's rows

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Max and sum over N (a power of two) adjacent lanes, the same value in each
template <int N>
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int N>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < N; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The keep bits of the thread's elements of a warp's (16, 8 nt) tile: bit
// 4c + e for element e of column tile c (rows ra and ra + 8, columns c0 +
// 8c + 2t and + 1, window-local; with keys_in_rows the rows are keys and the
// columns queries). Positions past the window, and above the diagonal under
// causal, draw nothing (0). The column loop is not unrolled, so the
// generator's code appears once however wide the tile: unrolled over a
// float32 tile it crowded the instruction cache.
__device__ __forceinline__ unsigned long long keep_bits(unsigned seed, unsigned prow, int S,
                                                        int w0, int W, int ra, int c0, int nt,
                                                        int causal, unsigned thresh,
                                                        bool keys_in_rows, int lane) {
  const int t = lane & 3;
  unsigned long long keep = 0ull;
#pragma unroll 1
  for (int c = 0; c < nt; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ra + 8 * (e >> 1), col = c0 + c * 8 + 2 * t + (e & 1);
      const int i = keys_in_rows ? col : r, j = keys_in_rows ? r : col;
      if (i < W && j < W && !(causal && j > i)) {
        const unsigned ctr = (unsigned)(w0 + i) * (unsigned)S + (unsigned)(w0 + j);
        keep |= (unsigned long long)(attn_keep_bits(seed, prow, ctr) < thresh) << (4 * c + e);
      }
    }
  return keep;
}

// Two consecutive outputs (row r, columns c and c + 1), rounded to Elem.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<unsigned*>(dst) = round_bf16x2(a, b);
}

// Two outputs of a ragged row (columns c and c + 1 of a row of Dh): the pair's store where
// every row starts on the pair's bytes (`pair`: the launch's copy is at least 2 E bytes;
// then c + 1 < Dh, and the pair is aligned), else each below Dh alone.
template <typename Elem>
__device__ __forceinline__ void store2_ragged(Elem* dst, float a, float b, int c, int Dh,
                                              bool pair) {
  if (c >= Dh) return;
  if (pair) {
    store2(dst, a, b);
    return;
  }
  dst[0] = from_float<Elem>(a);
  if (c + 1 < Dh) dst[1] = from_float<Elem>(b);
}

// Store the warp's (16, 8 NO) accumulator (NO tiles of 8 columns, all of DH's by
// default): rows ra and ra + 8 (those below W) at dst + ro(row), each value times the
// row's factor. Ragged: only the columns below Dh, `dst` being column c0 of its row.
template <typename Elem, int DH, int NO, bool RAGGED, typename RO>
__device__ __forceinline__ void store_rows(Elem* dst, RO ro, const float (&acc)[NO][4],
                                           int ra, int W, float fa, float fb, int lane,
                                           const Head& h, int c0 = 0) {
  const int t = lane & 3;
  const bool pair = h.copy >= 2 * (int)sizeof(Elem);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    if constexpr (RAGGED) {
      if (ra < W)
        store2_ragged(dst + ro(ra) + c, acc[n][0] * fa, acc[n][1] * fa, c0 + c, h.Dh, pair);
      if (ra + 8 < W)
        store2_ragged(dst + ro(ra + 8) + c, acc[n][2] * fb, acc[n][3] * fb, c0 + c, h.Dh,
                      pair);
    } else {
      if (ra < W) store2(dst + ro(ra) + c, acc[n][0] * fa, acc[n][1] * fa);
      if (ra + 8 < W) store2(dst + ro(ra + 8) + c, acc[n][2] * fb, acc[n][3] * fb);
    }
  }
}

}  // namespace k1
