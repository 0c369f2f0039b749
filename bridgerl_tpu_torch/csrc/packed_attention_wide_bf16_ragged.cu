// K1 at head dims past 128, bfloat16, the kernels' ragged form (rows staged in copies
// under 16 bytes): the C entry points packed_attention_fwd_bf16_wide_ragged and
// packed_attention_bwd_bf16_wide_ragged. The kernels, their launchers and the notes
// on their design are in k1_wide.cuh; packed_attention_wide_bf16.cu holds the native
// form. A library of its own, so that nvcc builds the two forms in parallel.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149) and _packed_attention_bwd (:164,
// pallas_call at :171), for bfloat16 inputs whose head dim is past 128.
#include "k1_wide.cuh"

extern "C" int packed_attention_fwd_bf16_wide_ragged(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                     const __nv_bfloat16* v, const float* bias,
                                                     __nv_bfloat16* out, int BH, int S, int W,
                                                     int Dh, int H, long long in_pos,
                                                     long long in_batch, long long out_pos,
                                                     long long out_batch, float scale,
                                                     const int* seed, int group_rows,
                                                     unsigned thresh, float inv_keep, int dropout,
                                                     int causal, int path, int blocks,
                                                     int smem_bytes, int copy, void* stream) {
  return dispatch_wide_fwd<true>(q, k, v, bias, out, BH, S, W, Dh, H, in_pos, in_batch, out_pos,
                                 out_batch, scale, seed, group_rows, thresh, inv_keep, dropout,
                                 causal, path, blocks, smem_bytes, copy, stream);
}

extern "C" int packed_attention_bwd_bf16_wide_ragged(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                     const __nv_bfloat16* v, const float* bias,
                                                     const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                                     __nv_bfloat16* dk, __nv_bfloat16* dv,
                                                     float* stats, int BH, int S, int W, int Dh,
                                                     int H, long long in_pos, long long in_batch,
                                                     long long out_pos, long long out_batch,
                                                     long long grad_pos, long long grad_batch,
                                                     float scale, const int* seed, int group_rows,
                                                     unsigned thresh, float inv_keep, int dropout,
                                                     int causal, int path, int blocks,
                                                     int smem_bytes, int blocks_kv, int smem_kv,
                                                     int copy, void* stream) {
  return dispatch_wide_bwd<true>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, Dh, H, in_pos,
                                 in_batch, out_pos, out_batch, grad_pos, grad_batch, scale, seed,
                                 group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                                 smem_bytes, blocks_kv, smem_kv, copy, stream);
}
