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
// K1's tensors in device memory are float32 or bfloat16 (the template
// argument Elem of both kernels; the bias is always float32). The tiles in
// shared memory are float32 either way: a bfloat16 row is read 8 bytes
// (4 values) a thread and widened as it is staged, which is exact, so
// everything after the staging is the float32 code. Outputs are rounded to
// Elem as they are stored, to nearest even, as torch's .to(bfloat16) and
// XLA's convert round.
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

// Two bfloat16 values packed low-first in a 32-bit word, widened exactly:
// a bfloat16 is the high half of the float32 with the same value.
__device__ __forceinline__ float2 widen_bf16x2(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned round_bf16x2(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// The tiles of NT tensors (q, k, v and, in the backward, dout): float32
// rows go by cp.async as above, one tensor after another.
template <int DH, int NT>
__device__ __forceinline__ void stage_tiles(float* const (&dst)[NT],
                                            const float* const (&src)[NT], int rows) {
#pragma unroll
  for (int t = 0; t < NT; ++t) stage_rows<DH>(dst[t], src[t], rows);
}

// bfloat16 rows are read with plain loads through the read-only path, 8
// bytes (4 values) a thread, neighbouring threads on neighbouring
// addresses, and widened into the same float32 tiles: each float4 goes to
// one 16-byte column of a padded row, as a cp.async would put it. A thread
// issues the loads of two columns of every tensor before it widens and
// stores any, so the block's loads are in flight together; they are
// complete when this returns.
template <int DH, int NT>
__device__ __forceinline__ void stage_tiles(float* const (&dst)[NT],
                                            const __nv_bfloat16* const (&src)[NT], int rows) {
  constexpr int QS = TileDims<DH>::QS, D4 = TileDims<DH>::D4;
  const int n = rows * D4;
  for (int e0 = threadIdx.x; e0 < n; e0 += 2 * blockDim.x) {
    uint2 u[2][NT];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * blockDim.x;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (e < n) u[h][t] = __ldg(reinterpret_cast<const uint2*>(src[t]) + e);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * blockDim.x;
      if (e < n) {
        const int r = e / D4, c = e - r * D4;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float2 a = widen_bf16x2(u[h][t].x), b = widen_bf16x2(u[h][t].y);
          *reinterpret_cast<float4*>(dst[t] + r * QS + 4 * c) =
              make_float4(a.x, a.y, b.x, b.y);
        }
      }
    }
  }
}

// One element of device memory, widened to float32 or rounded from it.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four consecutive outputs from a float4: one 16-byte store of float32, or
// one 8-byte store of bfloat16.
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(round_bf16x2(v.x, v.y), round_bf16x2(v.z, v.w));
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
