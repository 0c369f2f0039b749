// K1 at head dims past 128, float32: the C entry points
// packed_attention_fwd_wide and packed_attention_bwd_wide. The
// kernels, their launchers and the notes on their design are in
// k1_wide.cuh; the other dtype's entry points are packed_attention_wide_bf16.cu.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149) and _packed_attention_bwd (:164,
// pallas_call at :171), for float32 inputs whose head dim is past 128.
#include "k1_wide.cuh"

extern "C" int packed_attention_fwd_wide(const float* q, const float* k, const float* v,
                                         const float* bias, float* out, int BH, int S, int W,
                                         int Dh, int H, long long in_pos, long long in_batch,
                                         long long out_pos, long long out_batch, float scale,
                                         const int* seed, int group_rows, unsigned thresh,
                                         float inv_keep, int dropout, int causal, int path,
                                         int blocks, int smem_bytes, int copy, void* stream) {
  return dispatch_wide_fwd<false>(q, k, v, bias, out, BH, S, W, Dh, H, in_pos, in_batch, out_pos,
                                  out_batch, scale, seed, group_rows, thresh, inv_keep, dropout,
                                  causal, path, blocks, smem_bytes, copy, stream);
}

extern "C" int packed_attention_bwd_wide(const float* q, const float* k, const float* v,
                                         const float* bias, const float* dout, float* dq, float* dk,
                                         float* dv, float* stats, int BH, int S, int W, int Dh,
                                         int H, long long in_pos, long long in_batch,
                                         long long out_pos, long long out_batch, long long grad_pos,
                                         long long grad_batch, float scale, const int* seed,
                                         int group_rows, unsigned thresh, float inv_keep,
                                         int dropout, int causal, int path, int blocks,
                                         int smem_bytes, int blocks_kv, int smem_kv, int copy,
                                         void* stream) {
  return dispatch_wide_bwd<false>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, Dh, H, in_pos,
                                  in_batch, out_pos, out_batch, grad_pos, grad_batch, scale, seed,
                                  group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                                  smem_bytes, blocks_kv, smem_kv, copy, stream);
}
