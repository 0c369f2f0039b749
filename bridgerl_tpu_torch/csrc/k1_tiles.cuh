// Shared pieces of K1's window-tile path (packed_attention.cu and
// packed_attention_bwd.cu): the block shape, the shared-memory budget, and
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
#pragma once

#include <cuda_runtime.h>

namespace k1 {

constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 block may use
constexpr int kTileThreads = 128;   // threads of a window-tile block
constexpr int kTileRows = 20;       // query rows a block aims to hold: G = 20 / W windows
constexpr int kRowWarps = 8;        // warps of a row-path block (one query row each)

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
