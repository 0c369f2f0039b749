// K1 backward, bfloat16, past the window-resident kernel: the C entry point
// packed_attention_bwd_bf16_long, the two-kernel path (the row-buffered or two-sweep dq kernel,
// then the dk / dv kernel). The kernels, their launcher and the notes on
// their design are in k1_bwd.cuh; packed_attention_bwd_bf16.cu is the entry
// point of the one-kernel paths. A library of its own, so that nvcc builds the
// two in parallel.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_bwd
// (attention.py:164, pallas_call at :171), for bfloat16 inputs.
#include "k1_bwd.cuh"

extern "C" int packed_attention_bwd_bf16_long(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, const float* bias,
                                              const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                              __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats,
                                              int BH, int S, int W, int Dh, int H, long long in_pos,
                                              long long in_batch, long long out_pos,
                                              long long out_batch, long long grad_pos,
                                              long long grad_batch, float scale, const int* seed,
                                              int group_rows, unsigned thresh, float inv_keep,
                                              int dropout, int causal, int path, int blocks,
                                              int smem_bytes, int blocks_kv, int smem_kv, int copy,
                                              void* stream) {
  return dispatch<true, false>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, Dh, H, in_pos,
                               in_batch, out_pos, out_batch, grad_pos, grad_batch, scale, seed,
                               group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                               smem_bytes, blocks_kv, smem_kv, copy, stream);
}
