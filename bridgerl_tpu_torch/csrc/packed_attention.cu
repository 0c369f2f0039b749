// K1 forward: packed-window attention,
// out = dropout(softmax(q k^T * scale + bias)) v.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (pallas_call at :149, kernel body _attn_kernel at :51). The backward is
// csrc/packed_attention_bwd.cu.
//
// Shapes: q, k, v, out are (BH, S, Dh) float32, contiguous; bias is (S, S)
// float32 and is added to every row's logits (0 / -1e9 for the block-diagonal
// window mask, or zeros). Dh is one of 16, 32, 64, 128 (a template argument).
// With dropout on, element (i, j) of row r is kept when Philox word
// attn_keep_bits(seed, r, i * S + j) < thresh (philox.cuh) and is then scaled
// by inv_keep; the softmax's normaliser sums the probabilities before the
// mask, as the TPU kernel does. seed is read from device memory, so drawing
// it never waits for the card.
//
// What bounds it on an H100: at the flagship shape (2048, 80, 64) the
// function moves 168 MB (q, k, v read once, out written once: ~50 us at
// 3.35 TB/s) and does 3.4 GFLOP for q k^T and p v (~50 us on the 67 TFLOP/s
// of the float32 cores), so bytes and operations bound it about equally.
//
// Design: one block per (batch * head) row, eight warps. K and V of the row
// are staged once in shared memory (K with a padded row stride of Dh + 1, so
// that the 32 lanes reading 32 different keys hit 32 different banks); each
// warp takes query rows i = warp, warp + 8, ..., holds q_i in registers,
// computes its S logits lane-per-key, takes the f32 softmax with expf of
// s - max through warp shuffles, and accumulates p v lane-per-output-dim.
// The (S, S) logits never leave shared memory: the kernel reads q, k, v once
// and writes out once, which is the byte bound above. The arithmetic runs on
// the float32 cores from shared memory; it does not skip the across-window
// blocks that the -1e9 bias zeroes out (their probabilities are computed and
// are exactly 0), so any (S, S) bias is taken. Moving the products onto the
// tensor cores and skipping masked blocks is later work.
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int S, float scale,
                            const int* __restrict__ seed_ptr, unsigned thresh,
                            float inv_keep, int dropout) {
  extern __shared__ float smem[];
  constexpr int KS = DH + 1;                  // padded K row stride
  constexpr int DPL = (DH + 31) / 32;         // output dims per lane
  float* ks = smem;                           // S * KS
  float* vs = ks + S * KS;                    // S * DH
  float* ps = vs + S * DH;                    // kWarps * S

  const size_t base = (size_t)blockIdx.x * S * DH;
  const unsigned row = blockIdx.x;
  const unsigned seed = dropout ? (unsigned)seed_ptr[0] : 0u;
  const float* qr = q + base;
  const float* kr = k + base;
  const float* vr = v + base;
  float* orow = out + base;

  for (int i = threadIdx.x; i < S * DH; i += blockDim.x) {
    const int j = i / DH, d = i % DH;
    ks[j * KS + d] = kr[i];
    vs[i] = vr[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * S;
  for (int i = warp; i < S; i += kWarps) {
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qv[d] = qr[i * DH + d];

    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* kj = ks + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qv[d], kj[d], acc);
      const float s = acc * scale + bias[i * S + j];
      p[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - m);
      l += e;
      p[j] = !dropout ? e
             : attn_keep_bits(seed, row, (unsigned)(i * S + j)) < thresh ? e * inv_keep
                                                                         : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    __syncwarp();

    float acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < DH) acc[c] = fmaf(pj, vs[j * DH + d], acc[c]);
      }
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) orow[i * DH + d] = acc[c] * inv;
    }
    __syncwarp();  // p is rewritten by this warp's next query row
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, int BH, int S, float scale, const int* seed,
           unsigned thresh, float inv_keep, int dropout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)S * (2 * DH + 1) + kWarps * S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packed_attention_fwd_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  packed_attention_fwd_kernel<DH><<<BH, kWarps * 32, smem, stream>>>(
      q, k, v, bias, out, S, scale, seed, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int packed_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, int BH, int S, int Dh,
                                    float scale, const int* seed,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch<16>(q, k, v, bias, out, BH, S, scale, seed, thresh, inv_keep, dropout, st);
    case 32: return launch<32>(q, k, v, bias, out, BH, S, scale, seed, thresh, inv_keep, dropout, st);
    case 64: return launch<64>(q, k, v, bias, out, BH, S, scale, seed, thresh, inv_keep, dropout, st);
    case 128: return launch<128>(q, k, v, bias, out, BH, S, scale, seed, thresh, inv_keep, dropout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
