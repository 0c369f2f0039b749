// K1 forward, float32, the kernels' ragged form (head dims below the width they
// are staged at): the C entry point packed_attention_fwd_ragged. The kernels, their
// launcher and the notes on their design are in k1_fwd.cuh; packed_attention.cu is
// the native form's entry point. A library of its own, so that nvcc builds the two
// forms in parallel.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149), for float32 inputs.
#include "k1_fwd.cuh"

extern "C" int packed_attention_fwd_ragged(const float* q, const float* k, const float* v,
                                           const float* bias, float* out, int BH, int S, int W,
                                           int Dh, int H, long long in_pos, long long in_batch,
                                           long long out_pos, long long out_batch, float scale,
                                           const int* seed, int group_rows, unsigned thresh,
                                           float inv_keep, int dropout, int causal, int path,
                                           int blocks, int smem_bytes, int copy, void* stream) {
  return dispatch<true>(q, k, v, bias, out, BH, S, W, Dh, H, in_pos, in_batch, out_pos, out_batch,
                        scale, seed, group_rows, thresh, inv_keep, dropout, causal, path, blocks,
                        smem_bytes, copy, stream);
}
