// K2: nearest-code search with assignment statistics.
//   idx[n]    = first argmin_k ( ||e_k||^2 - 2 x_n . e_k )      (int32)
//   counts[k] = number of rows n with idx[n] == k                (float32)
//   dw[k, :]  = sum of the rows x_n with idx[n] == k             (float32)
//
// Replaces: bridgerl_tpu/ops/pallas/vq_kernel.py, nearest_codes_pallas
// (pallas_call at :118, kernel body _vq_assign_kernel at :51). The TPU kernel
// carries counts and dw from one grid step to the next on its sequential
// grid; Hopper blocks run in parallel and in no order, so here every block
// adds its rows into counts and dw with atomicAdd, into outputs that the
// caller zeroes first. Counts are exact integers; the order in which dw's
// sums are taken changes from run to run (float32 rounding, ~1e-6 relative).
//
// Shapes: x (N, D), codebook (K, D), float32, contiguous; any N >= 1,
// any K >= 1, D <= 512.
//
// What bounds it on an H100: at the slice's shape (N 4096, D 64, K 512) the
// distances are 268 MFLOP (~4 us on the 67 TFLOP/s of the float32 cores)
// against 1.4 MB of traffic (~0.4 us), so operations bound it.
//
// Design: one block of eight warps takes a tile of 32 rows (4 per warp),
// staged in shared memory. The codebook streams through shared memory in
// chunks of 32 codes (row stride D + 1, so the 32 lanes reading 32 codes hit
// 32 banks) with their squared norms; lane l scores code c0 + l against the
// warp's 4 rows and keeps a running (best, idx) with a strict < over codes
// in increasing order, so ties keep the lowest index. A warp shuffle then
// takes the first argmin across lanes (equal distances: lower index wins).
// The (N, K) distance and one-hot matrices never exist in device memory.
// The scores run on the float32 cores; a tensor-core distance product is
// later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileN = kWarps * kRowsPerWarp;
constexpr int kChunk = 32;  // codes per shared-memory chunk: one per lane

__global__ void __launch_bounds__(kWarps * 32)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 int* __restrict__ idx, float* __restrict__ counts,
                 float* __restrict__ dw, int N, int D, int K) {
  extern __shared__ float smem[];
  const int CS = D + 1;
  float* xs = smem;                  // kTileN * D
  float* cs = xs + kTileN * D;       // kChunk * CS
  float* cn = cs + kChunk * CS;      // kChunk squared norms

  const int row0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_here = min(kTileN, N - row0);
  for (int i = threadIdx.x; i < kTileN * D; i += blockDim.x)
    xs[i] = (i / D < rows_here) ? x[(size_t)row0 * D + i] : 0.f;

  float best[kRowsPerWarp];
  int bidx[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    best[r] = INFINITY;
    bidx[r] = 0;
  }
  const float* xw = xs + warp * kRowsPerWarp * D;

  for (int c0 = 0; c0 < K; c0 += kChunk) {
    const int kc = min(kChunk, K - c0);
    __syncthreads();  // the previous chunk has been scored
    for (int i = threadIdx.x; i < kc * D; i += blockDim.x)
      cs[(i / D) * CS + i % D] = cb[(size_t)c0 * D + i];
    __syncthreads();
    if (threadIdx.x < kc) {
      const float* e = cs + threadIdx.x * CS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(e[d], e[d], s);
      cn[threadIdx.x] = s;
    }
    __syncthreads();
    if (lane < kc) {
      const float* e = cs + lane * CS;
      float dot[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float ed = e[d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          dot[r] = fmaf(xw[r * D + d], ed, dot[r]);
      }
      const float norm = cn[lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float dist = norm - 2.f * dot[r];
        if (dist < best[r]) {
          best[r] = dist;
          bidx[r] = c0 + lane;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float b = best[r];
    int bi = bidx[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob < b || (ob == b && oi < bi)) {
        b = ob;
        bi = oi;
      }
    }
    const int local = warp * kRowsPerWarp + r;
    if (local < rows_here) {
      if (lane == 0) {
        idx[row0 + local] = bi;
        atomicAdd(&counts[bi], 1.f);
      }
      for (int d = lane; d < D; d += 32)
        atomicAdd(&dw[(size_t)bi * D + d], xs[local * D + d]);
    }
  }
}

}  // namespace

extern "C" int vq_assign(const float* x, const float* cb, int* idx,
                         float* counts, float* dw, int N, int D, int K,
                         void* stream) {
  if (N < 1 || K < 1 || D < 1 || D > 512) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kTileN * D + (size_t)kChunk * (D + 1) + kChunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vq_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + kTileN - 1) / kTileN;
  vq_assign_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, cb, idx, counts, dw, N, D, K);
  return (int)cudaGetLastError();
}
