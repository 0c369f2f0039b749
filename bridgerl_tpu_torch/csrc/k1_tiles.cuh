// Shared pieces of K1's window-tile path (k1_fwd.cuh and k1_bwd.cuh):
// the block shape, the shared-memory budget, and
// 16-byte asynchronous copies from device memory into shared memory. K2
// (vq_assign.cu) uses the budget, the copies and dot4 too.
//
// A window of W positions is W * Dh contiguous floats of a (BH, S, Dh)
// tensor, and window n = row * (S / W) + w starts at float n * W * Dh, so a
// block's G consecutive windows are one contiguous span. The block copies it
// with cp.async.cg (16 bytes a thread, neighbouring threads on neighbouring
// addresses, bypassing L1) into rows padded to Dh + 4 floats: row r's
// 16-byte column c then falls in bank group (r * (Dh / 4 + 1) + c) mod 8,
// so eight threads reading eight consecutive rows at one column hit eight
// different bank groups.
//
// The window tiles are K1's float32 kernels at W < kMinWindow (the bias is
// float32 in every dtype); bfloat16 at those windows runs the multi-window
// kernels of k1_multi.cuh, which stage their rows as they are. The other
// paths' bfloat16 outputs are rounded as they are stored, to nearest even, as
// torch's .to(bfloat16) and XLA's convert round (round_bf16x2, from_float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// rows' copies cannot be 16 bytes) reads and writes rows of Dh elements (the row stride in
// device memory) and stages them into tiles of DH columns, the columns from Dh on
// zero-filled, which adds nothing to q k^T, dout v^T or any product over the head dim;
// its stores write the columns below Dh only. Nothing else sees Dh: at Dh == DH the
// native form runs, whose code is the one instantiated at that width alone.
//
// The bytes of each staging copy (ops/attention.py::copy_bytes): row r of a 16-byte
// aligned tensor starts at byte r * Dh * E, so a copy of b bytes is aligned in every row
// where b divides Dh * E: 16 where it can, else 8 or 4 (cp.async), else 2 (bf16 at an odd
// Dh: plain 2-byte loads). The launchers pick it once a launch and refuse a plan that
// names another.
__host__ __device__ constexpr int copy_bytes(int Dh, int E) {
  return (Dh * E) % 16 == 0 ? 16 : (Dh * E) % 8 == 0 ? 8 : (Dh * E) % 4 == 0 ? 4 : 2;
}

// A launch's true head dim: its rows' stride and column bound, and the copies' bytes.
struct Head {
  int Dh, copy;
};

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

// Stage `rows` rows of `cols` columns (a multiple of 16 / E) from column c0 of `src` (row
// stride Dh) into `dst` (row stride ls elements) in copies of N bytes; rows at or past
// `valid` and columns at or past Dh are zero-filled, reading nothing (`safe` is any valid
// address). N divides Dh * E, so a copy lies wholly below Dh or wholly past it.
template <int N, typename Elem>
__device__ __forceinline__ void stage_chunks(Elem* dst, int ls, const Elem* src, int rows,
                                             int valid, int c0, int cols, int Dh,
                                             const Elem* safe) {
  constexpr int V = N / (int)sizeof(Elem);   // elements a copy
  const int n = cols / V;
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, c = (e - r * n) * V, col = c0 + c;
    const bool ok = r < valid && col < Dh;
    copy_zfill<N>(dst + r * ls + c, ok ? src + (size_t)r * Dh + col : safe, ok);
  }
}

// stage_chunks at the launch's copy size (one uniform switch a call).
template <typename Elem>
__device__ __forceinline__ void stage_ragged(Elem* dst, int ls, const Elem* src, int rows,
                                             int valid, int c0, int cols, Head h,
                                             const Elem* safe) {
  switch (h.copy) {
    case 16: stage_chunks<16>(dst, ls, src, rows, valid, c0, cols, h.Dh, safe); break;
    case 8: stage_chunks<8>(dst, ls, src, rows, valid, c0, cols, h.Dh, safe); break;
    case 4: stage_chunks<4>(dst, ls, src, rows, valid, c0, cols, h.Dh, safe); break;
    default:
      if constexpr (sizeof(Elem) == 2)
        stage_chunks<2>(dst, ls, src, rows, valid, c0, cols, h.Dh, safe);
  }
}

// Issue the copies of `rows` rows of DH floats, contiguous at `src`, into
// the padded tile `dst`.
template <int DH>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int rows) {
  constexpr int QS = TileDims<DH>::QS, D4 = TileDims<DH>::D4;
  for (int e = threadIdx.x; e < rows * D4; e += blockDim.x) {
    const int r = e / D4, c = e - r * D4;
    cp_async16(dst + r * QS + 4 * c, src + 4 * (size_t)e);
  }
}

__device__ __forceinline__ unsigned round_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The tiles of NT tensors (q, k, v and, in the backward, dout): float32
// rows by cp.async as above, one tensor after another (ragged: rows of Dh
// floats in copies of h.copy bytes, the columns from Dh zero-filled).
template <int DH, int NT, bool RAGGED = false>
__device__ __forceinline__ void stage_tiles(float* const (&dst)[NT],
                                            const float* const (&src)[NT], int rows,
                                            Head h = Head{DH, 16}) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if constexpr (RAGGED)
      stage_ragged(dst[t], TileDims<DH>::QS, src[t], rows, rows, 0, DH, h, src[t]);
    else
      stage_rows<DH>(dst[t], src[t], rows);
  }
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
// ragged, only the columns below Dh, store4 where Dh is a multiple of 4 (and so
// the four are aligned), else each alone.
template <bool RAGGED, typename Elem>
__device__ __forceinline__ void put4(Elem* dst, int col, float4 v, int Dh) {
  if constexpr (RAGGED) {
    if (col >= Dh) return;
    if (Dh & 3) {
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < Dh) dst[e] = from_float<Elem>(x[e]);
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
