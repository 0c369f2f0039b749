// K1 backward, float32: the C entry point packed_attention_bwd, the
// one-kernel paths (window tiles, the window-resident kernel). The kernels,
// their launcher and the notes on their design are in k1_bwd.cuh; the
// two-kernel path is packed_attention_bwd_long.cu, the other dtype's
// entry point packed_attention_bwd_bf16.cu.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_bwd
// (attention.py:164, pallas_call at :171), for float32 inputs.
#include "k1_bwd.cuh"

extern "C" int packed_attention_bwd(const float* q, const float* k, const float* v,
                                    const float* bias, const float* dout, float* dq, float* dk,
                                    float* dv, float* stats, int BH, int S, int W, int Dh, int H,
                                    long long in_pos, long long in_batch, long long out_pos,
                                    long long out_batch, long long grad_pos, long long grad_batch,
                                    float scale, const int* seed, int group_rows, unsigned thresh,
                                    float inv_keep, int dropout, int causal, int path, int blocks,
                                    int smem_bytes, int blocks_kv, int smem_kv, int copy,
                                    void* stream) {
  return dispatch<false, false>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, Dh, H, in_pos,
                                in_batch, out_pos, out_batch, grad_pos, grad_batch, scale, seed,
                                group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                                smem_bytes, blocks_kv, smem_kv, copy, stream);
}
