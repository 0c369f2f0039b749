// K1 backward: gradients of out = dropout(softmax(q k^T * scale + bias)) v
// with respect to q, k and v.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_bwd
// (pallas_call at :171, kernel body _attn_bwd_kernel at :75). Like the TPU
// kernel it recomputes the probabilities (flash-style) and regenerates the
// dropout mask from the seed (philox.cuh), so no (S, S) tensor is saved
// between the passes or written to device memory. bias gets no gradient.
//
// Per row, with p the softmax before dropout and keep the mask:
//   dv = p_drop^T do,  dp = keep * (do v^T) / keep_prob,
//   ds = p * (dp - rowsum(dp * p)) * scale,  dq = ds k,  dk = ds^T q.
//
// Shapes: q, k, v, dout, dq, dk, dv are (BH, S, Dh) float32, contiguous;
// bias is (S, S) float32. Dh is one of 16, 32, 64, 128.
//
// What bounds it on an H100: at the training shape (256, 80, 64) the
// function moves 7 * 256 * 80 * 64 * 4 = 36.7 MB (q, k, v, dout read once;
// dq, dk, dv written once: 11 us at 3.35 TB/s) and the TPU kernel's cost
// model counts 10 * BH * S^2 * Dh = 1.05 GFLOP (16 us at 67 TFLOP/s of
// float32 FMA), so it is bound by operations.
//
// Design: one block per (batch * head) row, eight warps, in two passes over
// the row, so that a block owns every output of its row: dk and dv need no
// atomics, and the result does not depend on scheduling.
//   Pass 1, per query row i (warp-strided): K and V staged in shared memory
//   with a padded row stride of Dh + 1 (32 lanes reading 32 keys hit 32
//   banks). The warp holds q_i in registers, computes the logits
//   lane-per-key, the row max and normaliser with shuffles, then loads do_i
//   into the same registers for dp, and reduces D_i = sum_j dp_ij p_ij. It
//   forms ds_i in a per-warp shared row and accumulates dq_i lane-per-dim.
//   The row's max, 1/l and D_i go to shared memory for pass 2.
//   Pass 2, per key column j: Q and dO replace K and V in shared memory; the
//   warp holds k_j (then v_j) in registers, recomputes p_ij lane-per-query
//   with the same fmaf order as pass 1 (bit-identical logits), applies the
//   mask, and accumulates dv_j = sum_i p_drop_ij do_i and
//   dk_j = sum_i ds_ij q_i lane-per-dim.
// Staging two (S, Dh + 1) tiles instead of four keeps Dh = 128, S = 120
// within the 227 KB a block may use. All products run on the float32 cores
// and the across-window blocks of a packed row are computed (their p is
// exactly 0). Tensor cores and skipping masked blocks are later work.
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_bwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ dk,
                            float* __restrict__ dv, int S, float scale,
                            const int* __restrict__ seed_ptr, unsigned thresh,
                            float inv_keep, int dropout) {
  extern __shared__ float smem[];
  constexpr int RS = DH + 1;                  // padded row stride
  constexpr int DPL = (DH + 31) / 32;         // output dims per lane
  float* ta = smem;                           // S * RS: k (pass 1), q (pass 2)
  float* tb = ta + S * RS;                    // S * RS: v (pass 1), dout (pass 2)
  float* wa = tb + S * RS;                    // kWarps * S: p row / p_drop column
  float* wb = wa + kWarps * S;                // kWarps * S: ds row / ds column
  float* row_m = wb + kWarps * S;             // S: row max of the logits
  float* row_il = row_m + S;                  // S: 1 / softmax normaliser
  float* row_d = row_il + S;                  // S: sum_j dp_ij p_ij

  const size_t base = (size_t)blockIdx.x * S * DH;
  const unsigned row = blockIdx.x;
  const unsigned seed = dropout ? (unsigned)seed_ptr[0] : 0u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = wa + warp * S;
  float* gw = wb + warp * S;

  // ---- pass 1: dq, and the row statistics
  for (int t = threadIdx.x; t < S * DH; t += blockDim.x) {
    const int j = t / DH, d = t % DH;
    ta[j * RS + d] = k[base + t];
    tb[j * RS + d] = v[base + t];
  }
  __syncthreads();

  for (int i = warp; i < S; i += kWarps) {
    float r[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = q[base + i * DH + d];
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* kj = ta + j * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(r[d], kj[d], acc);
      const float s = acc * scale + bias[i * S + j];
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(pw[j] - m);
      pw[j] = e;
      l += e;
    }
    const float il = 1.f / warp_sum(l);

#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = dout[base + i * DH + d];
    float dsum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* vj = tb + j * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(r[d], vj[d], acc);
      const float dp = !dropout ? acc
                       : attn_keep_bits(seed, row, (unsigned)(i * S + j)) < thresh
                           ? acc * inv_keep : 0.f;
      const float p = pw[j] * il;
      pw[j] = p;
      gw[j] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < S; j += 32) gw[j] = pw[j] * (gw[j] - dsum) * scale;
    __syncwarp();

    float acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float g = gw[j];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < DH) acc[c] = fmaf(g, ta[j * RS + d], acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) dq[base + i * DH + d] = acc[c];
    }
    if (lane == 0) {
      row_m[i] = m;
      row_il[i] = il;
      row_d[i] = dsum;
    }
    __syncwarp();  // pw and gw are rewritten by this warp's next row
  }
  __syncthreads();

  // ---- pass 2: dk and dv, one key column per warp
  for (int t = threadIdx.x; t < S * DH; t += blockDim.x) {
    const int i = t / DH, d = t % DH;
    ta[i * RS + d] = q[base + t];
    tb[i * RS + d] = dout[base + t];
  }
  __syncthreads();

  for (int j = warp; j < S; j += kWarps) {
    float r[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = k[base + j * DH + d];
    for (int i = lane; i < S; i += 32) {
      const float* qi = ta + i * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qi[d], r[d], acc);
      const float s = acc * scale + bias[i * S + j];
      pw[i] = expf(s - row_m[i]) * row_il[i];
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = v[base + j * DH + d];
    for (int i = lane; i < S; i += 32) {
      const float* doi = tb + i * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(doi[d], r[d], acc);
      const float p = pw[i];
      float pd = p, dp = acc;
      if (dropout) {
        const bool keep = attn_keep_bits(seed, row, (unsigned)(i * S + j)) < thresh;
        pd = keep ? p * inv_keep : 0.f;
        dp = keep ? acc * inv_keep : 0.f;
      }
      pw[i] = pd;
      gw[i] = p * (dp - row_d[i]) * scale;
    }
    __syncwarp();

    float adv[DPL], adk[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) adv[c] = adk[c] = 0.f;
    for (int i = 0; i < S; ++i) {
      const float pd = pw[i], g = gw[i];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < DH) {
          adv[c] = fmaf(pd, tb[i * RS + d], adv[c]);
          adk[c] = fmaf(g, ta[i * RS + d], adk[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) {
        dv[base + j * DH + d] = adv[c];
        dk[base + j * DH + d] = adk[c];
      }
    }
    __syncwarp();
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* bias,
           const float* dout, float* dq, float* dk, float* dv, int BH, int S,
           float scale, const int* seed, unsigned thresh, float inv_keep,
           int dropout, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)S * (DH + 1) + 2 * kWarps * S + 3 * (size_t)S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_bwd_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  packed_attention_bwd_kernel<DH><<<BH, kWarps * 32, smem, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, S, scale, seed, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int packed_attention_bwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* dout, float* dq, float* dk,
                                    float* dv, int BH, int S, int Dh,
                                    float scale, const int* seed,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
#define K1_BWD(DH_) \
  launch<DH_>(q, k, v, bias, dout, dq, dk, dv, BH, S, scale, seed, thresh, inv_keep, dropout, st)
  switch (Dh) {
    case 16: return K1_BWD(16);
    case 32: return K1_BWD(32);
    case 64: return K1_BWD(64);
    case 128: return K1_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_BWD
}
