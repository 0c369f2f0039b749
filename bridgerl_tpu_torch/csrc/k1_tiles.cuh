// Shared pieces of K1's window-tile path (k1_fwd.cuh and k1_bwd.cuh):
// the block shape, the shared-memory budget, and
// 16-byte asynchronous copies from device memory into shared memory. K2
// (vq_assign.cu) uses the budget, the copies and dot4 too.
//
// Where the rows lie (Head, Rows): row n = b * H + h of the (BH, S, Dh) problem keeps
// position s at element b * batch + h * Dh + s * pos of its tensor. The (BH, S, Dh)
// tensors of the 3-D entry points are H = 1, pos = Dh, batch = S * Dh; the fused
// projection's (B, S, 3d) buffer is pos = 3d, batch = S * 3d, with k and v at d and 2d
// (ops/attention.py::attention_qkv). A block of the window tiles takes G consecutive
// windows, whose rows may cross from one (b, h) to the next; where they do it takes each
// row's address from its flat position n * S + s (Divided: the divisions by S and H are a
// multiply, an add and a shift, Div), else from its first row (Strided). It copies with
// cp.async.cg (16 bytes a thread, neighbouring threads on neighbouring addresses,
// bypassing L1) into rows padded to Dh + 4 floats: row r's 16-byte column c then falls in
// bank group (r * (Dh / 4 + 1) + c) mod 8, so eight threads reading eight consecutive
// rows at one column hit eight different bank groups.
//
// The window tiles are K1's float32 kernels at W < kMinWindow (the bias is
// float32 in every dtype); bfloat16 at those windows runs the multi-window
// kernels of k1_multi.cuh, which stage their rows as they are. The other
// paths' bfloat16 outputs are rounded as they are stored, to nearest even, as
// torch's .to(bfloat16) and XLA's convert round (round_bf16x2, from_float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace k1 {

constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 block may use
constexpr int kTileThreads = 128;   // threads of a window-tile block
constexpr int kTileRows = 20;       // query rows a block aims to hold: G = 20 / W windows

template <int DH>
struct TileDims {
  static constexpr int QS = DH + 4;  // padded row stride of the q, k, v, dout tiles
  static constexpr int D4 = DH / 4;  // float4 columns of a row
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Head dims off the staged width. A kernel instantiated at DH runs any Dh <= DH: its
// ragged form (template argument RAGGED, which the launchers pick where Dh != DH or the
// rows' copies cannot be 16 bytes) reads and writes rows of Dh elements and stages them
// into tiles of DH columns, the columns from Dh on zero-filled, which adds nothing to
// q k^T, dout v^T or any product over the head dim; its stores write the columns below Dh
// only (past them lies the next head). Nothing else sees Dh: at Dh == DH the native form
// runs, whose code is the one instantiated at that width alone.
//
// The bytes of each staging copy (ops/attention.py::copy_bytes): the widest of 16, 8, 4
// and 2 that divides Dh * E, every stride and every tensor's address, in bytes
// (layout_copy), so that every row starts on it: 16 where it can, else 8 or 4 (cp.async),
// else 2 (bf16 at an odd Dh or offset: plain 2-byte loads). The launchers compute it once
// a launch and refuse a plan that names another. copy_bytes is the rule of contiguous
// (BH, S, Dh) rows on 16-byte addresses.
__host__ __device__ constexpr int copy_bytes(int Dh, int E) {
  return (Dh * E) % 16 == 0 ? 16 : (Dh * E) % 8 == 0 ? 8 : (Dh * E) % 4 == 0 ? 4 : 2;
}
__host__ __device__ constexpr int widest_copy(unsigned long long bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

// x / d for 0 <= x < 2^31 by a multiply-high, an add and a shift, branch-free, the
// divisor's constants made on the host (Granlund and Montgomery: with l = ceil(log2 d) and
// m = 2^32 (2^l - d) / d + 1, x / d = (umulhi(x, m) + x) >> l; d = 1 is m 1, l 0): a row's
// address costs no division.
struct Div {
  unsigned d, mul, shr;
  static Div of(unsigned d) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;   // ceil(log2 d)
    return Div{d, (unsigned)((((1ull << l) - d) << 32) / d + 1), l};
  }
  __device__ __forceinline__ unsigned operator()(unsigned x) const {
    return (__umulhi(x, mul) + x) >> shr;
  }
};

// One tensor's rows (q, k and v share theirs; dq, dk and dv theirs): elements from a
// position to the next and from a batch row to the next.
struct Rows {
  long long pos, batch;
};

// A launch's true head dim, its copies' bytes and where its rows lie: S positions a row,
// H heads a batch row; q, k, v (in), out or dout (out), dq, dk, dv (grad).
struct Head {
  int Dh, copy;
  Div S, H;
  Rows in, out, grad;
};

inline Head make_head(int Dh, int copy, int S, int H, Rows in, Rows out, Rows grad) {
  return Head{Dh, copy, Div::of((unsigned)S), Div::of((unsigned)H), in, out, grad};
}

// layout_copy over the launch's strides and its tensors' addresses (unused Rows are 0).
inline int layout_copy(const Head& h, int E, std::initializer_list<const void*> ptrs) {
  unsigned long long g = (unsigned long long)h.Dh * E;
  for (const Rows& L : {h.in, h.out, h.grad})
    g |= (unsigned long long)(L.pos | L.batch) * E;
  for (const void* p : ptrs) g |= (unsigned long long)(uintptr_t)p;
  return widest_copy(g);
}

// A launch's Head from its entry point's arguments: H heads a batch row (H divides BH),
// q, k and v at in_pos / in_batch, out or dout at out_pos / out_batch, dq, dk and dv at
// grad_pos / grad_batch (0 in the forward); BH * S below 2^31 (Div). False where the
// kernels cannot address the rows (no positions: S < 1, Div has no divisor 0), or `copy`
// is not layout_copy of them.
inline bool launch_head(int BH, int S, int Dh, int copy, int E, int H, long long in_pos,
                        long long in_batch, long long out_pos, long long out_batch,
                        long long grad_pos, long long grad_batch,
                        std::initializer_list<const void*> ptrs, Head& hd) {
  if (S < 1 || Dh < 1 || H < 1 || BH % H != 0 || (long long)BH * S >= (1LL << 31))
    return false;
  for (long long x : {in_pos, out_pos, grad_pos})   // a position's stride is an int
    if (x < 0 || x >= (1LL << 31)) return false;
  if (in_batch < 0 || out_batch < 0 || grad_batch < 0) return false;
  hd = make_head(Dh, copy, S, H, Rows{in_pos, in_batch}, Rows{out_pos, out_batch},
                 Rows{grad_pos, grad_batch});
  return copy == layout_copy(hd, E, ptrs);
}

// The element offsets of a block's rows, row r at ro(r). Strided: the rows of one window,
// or of a block whose rows are one run (all in one row n, or contiguous (BH, S, Dh)
// rows), `ld` apart from the first: the contiguous rows' code before the layout. Divided:
// the flat positions P0 + r of the (BH * S) rows, across rows n, each row's (n, s)
// divided out of its position. The kernels whose blocks hold several windows (the window
// tiles, the multi-window kernels, and the wide forward and one-kernel backward at W <=
// 32) take a template argument SPAN, which the launchers set where some block's rows cross
// from one row n to the next (spans_rows); the others' blocks hold one window. Both forms
// are built where they are used, from the kernel's Head parameter.
struct Strided {
  size_t base;
  int ld;
  __device__ __forceinline__ size_t operator()(int r) const {
    return base + (unsigned long long)(unsigned)r * (unsigned)ld;
  }
  __device__ __forceinline__ Strided from(int r) const { return Strided{(*this)(r), ld}; }
};
// The element of flat position P = n * S + s under L (row n = b * H + h).
__device__ __forceinline__ size_t flat_at(Div S, Div H, int Dh, Rows L, unsigned P) {
  const unsigned n = S(P), b = H(n);
  return (unsigned long long)b * (unsigned long long)L.batch + (n - b * H.d) * (unsigned)Dh +
         (unsigned long long)(P - n * S.d) * (unsigned)L.pos;
}
struct Divided {
  Div S, H;
  int Dh;
  Rows L;
  unsigned P0;
  __device__ __forceinline__ size_t operator()(int r) const {
    return flat_at(S, H, Dh, L, P0 + (unsigned)r);
  }
  __device__ __forceinline__ Divided from(int r) const {
    return Divided{S, H, Dh, L, P0 + (unsigned)r};
  }
};
enum Which { kIn, kOut, kGrad };   // q, k, v; out or dout; dq, dk, dv
__device__ __forceinline__ Rows rows_of(const Head& h, Which w) {
  return w == kIn ? h.in : w == kOut ? h.out : h.grad;
}
// A block's rows from flat position P0 under one of the Head's Rows.
template <bool SPAN>
__device__ __forceinline__ auto block_rows(const Head& h, Which w, unsigned P0) {
  const Rows L = rows_of(h, w);
  if constexpr (SPAN)
    return Divided{h.S, h.H, h.Dh, L, P0};
  else
    return Strided{flat_at(h.S, h.H, h.Dh, L, P0), (int)L.pos};
}
// The rows of window n (flat position n * W on): one run.
__device__ __forceinline__ Strided window_rows(const Head& h, Which w, int n, int W) {
  return block_rows<false>(h, w, (unsigned)n * (unsigned)W);
}
// Whether a launch whose blocks take `per_block` consecutive positions each (a block's G
// windows) has a block whose rows cross from one row n to the next: not where every
// tensor's rows are contiguous (BH, S, Dh) rows (or unused, 0), nor where per_block
// divides S (a block then lies in one row).
inline bool spans_rows(const Head& h, int per_block) {
  const unsigned S = h.S.d;
  bool flat = h.H.d == 1;
  for (const Rows& L : {h.in, h.out, h.grad})
    flat = flat && L.batch == (long long)S * L.pos;
  return !flat && S % (unsigned)per_block != 0;
}

// One copy of N bytes into shared memory, zero-filled where !ok (nothing is read then):
// cp.async for 16 (bypassing L1), 8 and 4; a plain load for 2 (bf16 only).
template <int N, typename Elem>
__device__ __forceinline__ void copy_zfill(Elem* smem, const Elem* gmem, bool ok) {
  if constexpr (N == 2) {
    static_assert(sizeof(Elem) == 2, "2-byte copies are bf16 elements");
    *reinterpret_cast<unsigned short*>(smem) =
        ok ? __ldg(reinterpret_cast<const unsigned short*>(gmem)) : (unsigned short)0;
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (N == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                   "r"(ok ? 16 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                   "n"(N), "r"(ok ? N : 0));
  }
}

// Stage `rows` rows of `cols` columns (a multiple of 16 / E) from column c0 of the rows
// of `src` at ro(r) into `dst` (row stride ls elements) in copies of N bytes; rows at or
// past `valid` and columns at or past Dh are zero-filled, reading nothing (`safe` is any
// valid address). N divides Dh * E, so a copy lies wholly below Dh or wholly past it.
template <int N, typename Elem, typename RO>
__device__ __forceinline__ void stage_chunks(Elem* dst, int ls, const Elem* src, RO ro,
                                             int rows, int valid, int c0, int cols, int Dh,
                                             const Elem* safe) {
  constexpr int V = N / (int)sizeof(Elem);   // elements a copy
  const int n = cols / V;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, c = (e - r * n) * V, col = c0 + c;
    const bool ok = r < valid && col < Dh;
    copy_zfill<N>(dst + r * ls + c, ok ? src + ro(r) + col : safe, ok);
  }
}

// stage_chunks at the launch's copy size (one uniform switch a call).
template <typename Elem, typename RO>
__device__ __forceinline__ void stage_ragged(Elem* dst, int ls, const Elem* src, RO ro,
                                             int rows, int valid, int c0, int cols,
                                             const Head& h, const Elem* safe) {
  switch (h.copy) {
    case 16: stage_chunks<16>(dst, ls, src, ro, rows, valid, c0, cols, h.Dh, safe); break;
    case 8: stage_chunks<8>(dst, ls, src, ro, rows, valid, c0, cols, h.Dh, safe); break;
    case 4: stage_chunks<4>(dst, ls, src, ro, rows, valid, c0, cols, h.Dh, safe); break;
    default:
      if constexpr (sizeof(Elem) == 2)
        stage_chunks<2>(dst, ls, src, ro, rows, valid, c0, cols, h.Dh, safe);
  }
}

// Issue the copies of `rows` rows of DH floats, row r at src + ro(r), into the padded
// tile `dst`.
template <int DH, typename RO>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, RO ro,
                                           int rows) {
  constexpr int QS = TileDims<DH>::QS, D4 = TileDims<DH>::D4;
  for (int e = threadIdx.x; e < rows * D4; e += blockDim.x) {
    const int r = e / D4, c = e - r * D4;
    cp_async16(dst + r * QS + 4 * c, src + ro(r) + 4 * c);
  }
}

__device__ __forceinline__ unsigned round_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// One tensor's tile (q, k, v and, in the backward, dout): float32 rows by cp.async as
// above (ragged: rows of Dh floats in copies of h.copy bytes, the columns from Dh
// zero-filled).
template <int DH, bool RAGGED, typename RO>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, RO ro, int rows,
                                           const Head& h) {
  if constexpr (RAGGED)
    stage_ragged(dst, TileDims<DH>::QS, src, ro, rows, rows, 0, DH, h, src);
  else
    stage_rows<DH>(dst, src, ro, rows);
}

// One output element, rounded from float32 to its type.
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive float32 outputs from a float4: one 16-byte store.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// Four consecutive outputs at `dst`, columns col .. col + 3 of their row: store4;
// ragged, only the columns below Dh, store4 where every row starts on 16 bytes (copy 16:
// the four are then aligned), else each alone.
template <bool RAGGED, typename Elem>
__device__ __forceinline__ void put4(Elem* dst, int col, float4 v, const Head& h) {
  if constexpr (RAGGED) {
    if (col >= h.Dh) return;
    if (h.copy < 16) {
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < h.Dh) dst[e] = from_float<Elem>(x[e]);
      return;
    }
  }
  store4(dst, v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Windows per block: about kTileRows query rows, within the shared-memory
// budget, at least one; 0 when one window does not fit.
inline int windows_per_block(size_t bytes_per_window, int W, int nwin) {
  if (bytes_per_window > (size_t)kSmemLimit) return 0;
  int G = kTileRows / W > 1 ? kTileRows / W : 1;
  const int fit = (int)(kSmemLimit / bytes_per_window);
  if (G > fit) G = fit;
  if (G > nwin) G = nwin;
  return G;
}

// Allow `bytes` of dynamic shared memory beyond the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace k1
