// K1 forward, bfloat16: the C entry point packed_attention_fwd_bf16. The
// launcher and the notes on the design are in k1_fwd.cuh, the kernels of
// windows under 32 in k1_multi.cuh; the float32 entry point is
// packed_attention.cu.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149), for bfloat16 inputs.
#include "k1_fwd.cuh"

extern "C" int packed_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const float* bias,
                                         __nv_bfloat16* out, int BH, int S, int W, int Dh, int H,
                                         long long in_pos, long long in_batch, long long out_pos,
                                         long long out_batch, float scale, const int* seed,
                                         int group_rows, unsigned thresh, float inv_keep,
                                         int dropout, int causal, int path, int blocks,
                                         int smem_bytes, int copy, void* stream) {
  return dispatch<false>(q, k, v, bias, out, BH, S, W, Dh, H, in_pos, in_batch, out_pos, out_batch,
                         scale, seed, group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                         smem_bytes, copy, stream);
}
