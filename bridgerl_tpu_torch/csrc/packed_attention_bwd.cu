// K1 backward: gradients of out = dropout(softmax(q k^T * scale + bias)) v
// with respect to q, k and v, within windows of W positions of each packed
// row.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_bwd
// (attention.py:164, pallas_call at :171, kernel body _attn_bwd_kernel at
// :75). Like the TPU kernel it recomputes the probabilities (flash-style)
// and regenerates the dropout mask from the seed (philox.cuh), so no
// (S, S) tensor is saved between the directions or written to device
// memory. bias gets no gradient.
//
// Per window, with p the softmax before dropout and keep the mask:
//   dv = p_drop^T do,  dp = keep * (do v^T) / keep_prob,
//   ds = p * (dp - rowsum(dp * p)) * scale,  dq = ds k,  dk = ds^T q.
//
// Shapes: q, k, v, dout, dq, dk, dv are (BH, S, Dh), contiguous, 16-byte
// aligned, all float32 (entry point packed_attention_bwd) or all bfloat16
// (packed_attention_bwd_bf16); bias is (S, S) float32 in both, read only
// inside the diagonal (W, W) blocks. Under bfloat16, as in the TPU kernel,
// the inputs are widened to float32 as they are read, everything inside is
// float32, and dq, dk and dv are rounded to bfloat16 once, as they are
// stored (k1_tiles.cuh). W divides S. Dh is one of 16, 32, 64, 128. Element (i, j)
// of row r keeps the forward's Philox counter i * S + j, i and j positions
// in the packed row, and the forward's seed groups (group_rows rows a seed,
// philox.cuh).
//
// Only the diagonal blocks, and that is exact: with the model's -1e9 bias
// across windows, every across-window p is exactly 0 in f32, so those
// blocks add exactly 0 to dv, to rowsum(dp * p), and (through ds = p * ...)
// to dq and dk. A window therefore owns every output of its rows and keys:
// dk_j and dv_j sum over the window's W query rows only.
//
// What bounds it on an H100: at the training shape (256, 80, 64), W = 10,
// the function moves 7 * 4 * BH * S * Dh = 36.7 MB (q, k, v, dout read once;
// dq, dk, dv written once: 11 us at 3.35 TB/s) and needs about
// 10 * BH * S * W * Dh = 131 MFLOP (2 us at the 67 TFLOP/s of the float32
// cores). That is 3.6 FLOP a byte against the ~20 the float32 cores need
// before they set the pace: it is bound by bytes. In bfloat16 the bytes
// halve (5.5 us at the training shape) and it stays bound by them.
//
// Design (window tiles), one pass per window: a block of 128 threads takes
// G = 20 / W consecutive windows (one contiguous span of device memory) and
// copies q, k, v and dout with 16-byte cp.async into padded shared rows
// (k1_tiles.cuh; bfloat16 rows are loaded 8 bytes a thread and widened
// before the next step); the grid covers the windows (1,024 blocks at the
// training shape). While the copies are in flight, one thread per element
// fetches bias_ij and computes the keep factor (0 or 1 / keep) from the
// same Philox counter as the forward. Then, in shared memory:
//   1. one thread per 2 x 2 tile of (i, j) computes the logits s_ij =
//      q_i . k_j * scale + bias and do_i . v_j (each float4 read feeds two
//      products), and dp_ij = keep factor * do_i . v_j;
//   2. one thread per query row takes the f32 softmax with expf(s - m),
//      D_i = sum_j dp_ij p_ij, ds_ij = p_ij (dp_ij - D_i) * scale, and
//      p_drop_ij = p_ij * keep factor;
//   3. dq = ds k, dk = ds^T q and dv = p_drop^T do for two rows at one
//      16-byte column a thread, written once with 16-byte stores.
// Each window's logits are computed once; there are no atomics and the
// summation order does not depend on scheduling. The block's phases run one
// after another and the load overlaps nothing inside a block: that chain,
// not the bytes, sets the time at the training shape (PERF.md).
// Windows too large for one block's shared memory (Dh = 128, W = S = 120,
// the general-bias cases) take the row path below: one block per window in
// two passes (query rows for dq, then key columns for dk and dv), which
// stages two (W, Dh + 1) tiles at a time instead of four.
//
// Why not the tensor cores: the kernel is bound by bytes, and TF32's 10-bit
// mantissa would break the 1e-4 agreement with the float32 plain version.
// Its products run on the float32 cores from shared memory.
#include <cuda_runtime.h>
#include <math.h>

#include "k1_tiles.cuh"
#include "philox.cuh"

namespace {

using k1::kRowWarps;
using k1::TileDims;

template <typename Elem, int DH>
__global__ void __launch_bounds__(k1::kTileThreads)
k1_bwd_tiles(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, const float* __restrict__ bias,
             const Elem* __restrict__ dout, Elem* __restrict__ dq,
             Elem* __restrict__ dk, Elem* __restrict__ dv, int S, int W, int G,
             int nwin, float scale, const int* __restrict__ seed_ptr, int group_rows,
             unsigned thresh, float inv_keep, int dropout) {
  extern __shared__ float4 smem4[];
  constexpr int QS = TileDims<DH>::QS, D4 = TileDims<DH>::D4;
  const int PS = W + 1;
  const int n0 = blockIdx.x * G;
  const int g = min(G, nwin - n0);
  const int rows = g * W;
  float* qs = reinterpret_cast<float*>(smem4);   // G * W * QS each
  float* ks = qs + G * W * QS;
  float* vs = ks + G * W * QS;
  float* os = vs + G * W * QS;                   // dout
  float* ps = os + G * W * QS;                   // G * W * PS: logits, p, then p_drop
  float* gs = ps + G * W * PS;                   // G * W * PS: dp, then ds
  float* kf = gs + G * W * PS;                   // G * W * PS: keep factors

  const size_t gbase = (size_t)n0 * W * DH;
  {
    float* const dst[4] = {qs, ks, vs, os};
    const Elem* const src[4] = {q + gbase, k + gbase, v + gbase, dout + gbase};
    k1::stage_tiles<DH>(dst, src, rows);
  }

  // While the copies are in flight: every element's bias and keep factor,
  // one thread per element, so that neither sits in the logits' chain.
  const int nwr = S / W;  // windows per packed row
  const int WW = W * W;
  for (int e = threadIdx.x; e < g * WW; e += blockDim.x) {
    const int lw = e / WW, ij = e - lw * WW;
    const int i = ij / W, j = ij - i * W;
    const int n = n0 + lw;
    const int w0 = (n % nwr) * W;
    const size_t pos = (size_t)(w0 + i) * S + (w0 + j);
    const int at = (lw * W + i) * PS + j;
    ps[at] = __ldg(bias + pos);
    if (dropout)
      kf[at] = attn_keep_bits_grouped(seed_ptr, group_rows, (unsigned)(n / nwr),
                                      (unsigned)pos) < thresh ? inv_keep : 0.f;
  }
  k1::cp_async_wait_all();
  __syncthreads();

  const int T = (W + 1) / 2, TT = T * T;  // 2 x 2 tiles of a window's logits
  for (int e = threadIdx.x; e < g * TT; e += blockDim.x) {
    const int lw = e / TT, t = e - lw * TT;
    const int i0 = 2 * (t / T), j0 = 2 * (t % T);
    const int top = lw * W;
    const int ra = (top + i0) * QS, rb = (top + min(i0 + 1, W - 1)) * QS;
    const int ca = (top + j0) * QS, cb = (top + min(j0 + 1, W - 1)) * QS;
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < D4; ++c) {
      const float4 q0 = reinterpret_cast<const float4*>(qs + ra)[c];
      const float4 q1 = reinterpret_cast<const float4*>(qs + rb)[c];
      const float4 k0 = reinterpret_cast<const float4*>(ks + ca)[c];
      const float4 k1v = reinterpret_cast<const float4*>(ks + cb)[c];
      s[0][0] = k1::dot4(q0, k0, s[0][0]);
      s[0][1] = k1::dot4(q0, k1v, s[0][1]);
      s[1][0] = k1::dot4(q1, k0, s[1][0]);
      s[1][1] = k1::dot4(q1, k1v, s[1][1]);
      const float4 o0 = reinterpret_cast<const float4*>(os + ra)[c];
      const float4 o1 = reinterpret_cast<const float4*>(os + rb)[c];
      const float4 v0 = reinterpret_cast<const float4*>(vs + ca)[c];
      const float4 v1 = reinterpret_cast<const float4*>(vs + cb)[c];
      dp[0][0] = k1::dot4(o0, v0, dp[0][0]);
      dp[0][1] = k1::dot4(o0, v1, dp[0][1]);
      dp[1][0] = k1::dot4(o1, v0, dp[1][0]);
      dp[1][1] = k1::dot4(o1, v1, dp[1][1]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (i0 + a >= W || j0 + b >= W) continue;
        const int at = (top + i0 + a) * PS + j0 + b;
        ps[at] = s[a][b] * scale + ps[at];
        gs[at] = dropout ? dp[a][b] * kf[at] : dp[a][b];
      }
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* pr = ps + r * PS;
    float* gr = gs + r * PS;
    float m = -INFINITY;
    for (int j = 0; j < W; ++j) m = fmaxf(m, pr[j]);
    float l = 0.f;
    for (int j = 0; j < W; ++j) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      l += e;
    }
    const float il = 1.f / l;
    float dsum = 0.f;
    for (int j = 0; j < W; ++j) {
      const float p = pr[j] * il;
      pr[j] = p;
      dsum = fmaf(gr[j], p, dsum);
    }
    for (int j = 0; j < W; ++j) {
      const float p = pr[j];
      gr[j] = p * (gr[j] - dsum) * scale;
      if (dropout) pr[j] = p * kf[r * PS + j];
    }
  }
  __syncthreads();

  // Rows a0 and a0 + 1 of a window at one 16-byte column, so that each
  // operand row read from shared memory feeds two outputs:
  //   dq_a = sum_j ds_aj k_j,  then  dk_a = sum_i ds_ia q_i, dv_a = sum_i p_drop_ia do_i.
  for (int e = threadIdx.x; e < g * T * D4; e += blockDim.x) {
    const int pair = e / D4, c = e - pair * D4;
    const int lw = pair / T, a0 = 2 * (pair - lw * T);
    const int top = lw * W;
    const int r0 = top + a0, r1 = top + min(a0 + 1, W - 1);
    const float* kw = ks + top * QS + 4 * c;
    const float* g0 = gs + r0 * PS;
    const float* g1 = gs + r1 * PS;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    for (int j = 0; j < W; ++j) {
      const float4 kj = *reinterpret_cast<const float4*>(kw + j * QS);
      x0 = k1::axpy4(g0[j], kj, x0);
      x1 = k1::axpy4(g1[j], kj, x1);
    }
    Elem* out = dq + gbase + (size_t)r0 * DH + 4 * c;
    k1::store4(out, x0);
    if (a0 + 1 < W) k1::store4(out + DH, x1);
  }
  for (int e = threadIdx.x; e < g * T * D4; e += blockDim.x) {
    const int pair = e / D4, c = e - pair * D4;
    const int lw = pair / T, a0 = 2 * (pair - lw * T);
    const int top = lw * W;
    const int b0 = a0, b1 = min(a0 + 1, W - 1);
    const float* qw = qs + top * QS + 4 * c;
    const float* ow = os + top * QS + 4 * c;
    const float* gc = gs + top * PS;
    const float* pc = ps + top * PS;
    float4 k0 = make_float4(0.f, 0.f, 0.f, 0.f), k1v = k0, v0 = k0, v1 = k0;
    for (int i = 0; i < W; ++i) {
      const float4 qi = *reinterpret_cast<const float4*>(qw + i * QS);
      const float4 oi = *reinterpret_cast<const float4*>(ow + i * QS);
      k0 = k1::axpy4(gc[i * PS + b0], qi, k0);
      k1v = k1::axpy4(gc[i * PS + b1], qi, k1v);
      v0 = k1::axpy4(pc[i * PS + b0], oi, v0);
      v1 = k1::axpy4(pc[i * PS + b1], oi, v1);
    }
    const size_t at = gbase + (size_t)(top + a0) * DH + 4 * c;
    k1::store4(dk + at, k0);
    k1::store4(dv + at, v0);
    if (a0 + 1 < W) {
      k1::store4(dk + at + DH, k1v);
      k1::store4(dv + at + DH, v1);
    }
  }
}

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

// Row path, for windows too large to tile: one block of eight warps per
// window, in two passes, so that the block owns every output of its window.
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
template <typename Elem, int DH>
__global__ void __launch_bounds__(kRowWarps * 32)
k1_bwd_rows(const Elem* __restrict__ q, const Elem* __restrict__ k,
            const Elem* __restrict__ v, const float* __restrict__ bias,
            const Elem* __restrict__ dout, Elem* __restrict__ dq,
            Elem* __restrict__ dk, Elem* __restrict__ dv, int S, int W, float scale,
            const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
            int dropout) {
  extern __shared__ float smem[];
  constexpr int RS = DH + 1;                  // padded row stride
  constexpr int DPL = (DH + 31) / 32;         // output dims per lane
  float* ta = smem;                           // W * RS: k (pass 1), q (pass 2)
  float* tb = ta + W * RS;                    // W * RS: v (pass 1), dout (pass 2)
  float* wa = tb + W * RS;                    // kRowWarps * W: p row / p_drop column
  float* wb = wa + kRowWarps * W;             // kRowWarps * W: ds row / ds column
  float* row_m = wb + kRowWarps * W;          // W: row max of the logits
  float* row_il = row_m + W;                  // W: 1 / softmax normaliser
  float* row_d = row_il + W;                  // W: sum_j dp_ij p_ij

  const int n = blockIdx.x, nwr = S / W;
  const int w0 = (n % nwr) * W;
  const unsigned grp = (unsigned)(n / nwr) / (unsigned)group_rows;  // seed group
  const unsigned row = (unsigned)(n / nwr) - grp * (unsigned)group_rows;
  const size_t base = (size_t)n * W * DH;
  const unsigned seed = dropout ? (unsigned)seed_ptr[grp] : 0u;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = wa + warp * W;
  float* gw = wb + warp * W;
  auto at = [&](int i, int j) { return (size_t)(w0 + i) * S + (w0 + j); };

  // ---- pass 1: dq, and the row statistics
  for (int t = threadIdx.x; t < W * DH; t += blockDim.x) {
    const int j = t / DH, d = t % DH;
    ta[j * RS + d] = k1::to_float(k[base + t]);
    tb[j * RS + d] = k1::to_float(v[base + t]);
  }
  __syncthreads();

  for (int i = warp; i < W; i += kRowWarps) {
    float r[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = k1::to_float(q[base + i * DH + d]);
    float m = -INFINITY;
    for (int j = lane; j < W; j += 32) {
      const float* kj = ta + j * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(r[d], kj[d], acc);
      const float s = acc * scale + bias[at(i, j)];
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < W; j += 32) {
      const float e = expf(pw[j] - m);
      pw[j] = e;
      l += e;
    }
    const float il = 1.f / warp_sum(l);

#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = k1::to_float(dout[base + i * DH + d]);
    float dsum = 0.f;
    for (int j = lane; j < W; j += 32) {
      const float* vj = tb + j * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(r[d], vj[d], acc);
      const float dp = !dropout ? acc
                       : attn_keep_bits(seed, row, (unsigned)at(i, j)) < thresh
                           ? acc * inv_keep : 0.f;
      const float p = pw[j] * il;
      pw[j] = p;
      gw[j] = dp;
      dsum = fmaf(dp, p, dsum);
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < W; j += 32) gw[j] = pw[j] * (gw[j] - dsum) * scale;
    __syncwarp();

    float acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
    for (int j = 0; j < W; ++j) {
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
      if (d < DH) dq[base + i * DH + d] = k1::from_float<Elem>(acc[c]);
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
  for (int t = threadIdx.x; t < W * DH; t += blockDim.x) {
    const int i = t / DH, d = t % DH;
    ta[i * RS + d] = k1::to_float(q[base + t]);
    tb[i * RS + d] = k1::to_float(dout[base + t]);
  }
  __syncthreads();

  for (int j = warp; j < W; j += kRowWarps) {
    float r[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = k1::to_float(k[base + j * DH + d]);
    for (int i = lane; i < W; i += 32) {
      const float* qi = ta + i * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qi[d], r[d], acc);
      const float s = acc * scale + bias[at(i, j)];
      pw[i] = expf(s - row_m[i]) * row_il[i];
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = k1::to_float(v[base + j * DH + d]);
    for (int i = lane; i < W; i += 32) {
      const float* doi = tb + i * RS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(doi[d], r[d], acc);
      const float p = pw[i];
      float pd = p, dp = acc;
      if (dropout) {
        const bool keep = attn_keep_bits(seed, row, (unsigned)at(i, j)) < thresh;
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
    for (int i = 0; i < W; ++i) {
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
        dv[base + j * DH + d] = k1::from_float<Elem>(adv[c]);
        dk[base + j * DH + d] = k1::from_float<Elem>(adk[c]);
      }
    }
    __syncwarp();
  }
}

template <typename Elem, int DH>
int launch(const Elem* q, const Elem* k, const Elem* v, const float* bias,
           const Elem* dout, Elem* dq, Elem* dk, Elem* dv, int BH, int S, int W,
           float scale, const int* seed, int group_rows, unsigned thresh, float inv_keep,
           int dropout, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  constexpr int QS = TileDims<DH>::QS;
  const size_t per_window =
      sizeof(float) * ((size_t)4 * W * QS + 3 * (size_t)W * (W + 1));
  const int G = k1::windows_per_block(per_window, W, nwin);
  if (G > 0) {
    const size_t smem = G * per_window;
    const cudaError_t e = k1::allow_smem(k1_bwd_tiles<Elem, DH>, smem);
    if (e != cudaSuccess) return (int)e;
    k1_bwd_tiles<Elem, DH><<<(nwin + G - 1) / G, k1::kTileThreads, smem, stream>>>(
        q, k, v, bias, dout, dq, dk, dv, S, W, G, nwin, scale, seed, group_rows, thresh, inv_keep,
        dropout);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      sizeof(float) * (2 * (size_t)W * (DH + 1) + 2 * kRowWarps * W + 3 * (size_t)W);
  if (smem > (size_t)k1::kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t e = k1::allow_smem(k1_bwd_rows<Elem, DH>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_bwd_rows<Elem, DH><<<nwin, kRowWarps * 32, smem, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, S, W, scale, seed, group_rows, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch(const Elem* q, const Elem* k, const Elem* v, const float* bias, const Elem* dout, Elem* dq,
             Elem* dk, Elem* dv, int BH, int S, int W, int Dh, float scale, const int* seed, int group_rows,
             
             unsigned thresh, float inv_keep, int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (W < 1 || S % W != 0) return (int)cudaErrorInvalidValue;
  if (group_rows < 1 || BH % group_rows != 0) return (int)cudaErrorInvalidValue;
#define K1_BWD(DH_) \
  launch<Elem, DH_>(q, k, v, bias, dout, dq, dk, dv, BH, S, W, scale, seed, group_rows, \
                    thresh, inv_keep, dropout, st)
  switch (Dh) {
    case 16: return K1_BWD(16);
    case 32: return K1_BWD(32);
    case 64: return K1_BWD(64);
    case 128: return K1_BWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_BWD
}

}  // namespace

extern "C" int packed_attention_bwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* dout, float* dq, float* dk,
                                    float* dv, int BH, int S, int W, int Dh,
                                    float scale, const int* seed, int group_rows,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  return dispatch(q, k, v, bias, dout, dq, dk, dv, BH, S, W, Dh, scale, seed, group_rows, thresh,
                  inv_keep, dropout, stream);
}

extern "C" int packed_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const float* bias,
                                         const __nv_bfloat16* dout, __nv_bfloat16* dq,
                                         __nv_bfloat16* dk, __nv_bfloat16* dv, int BH,
                                         int S, int W, int Dh, float scale, const int* seed, int group_rows,
                                         
                                         unsigned thresh, float inv_keep,
                                         int dropout, void* stream) {
  return dispatch(q, k, v, bias, dout, dq, dk, dv, BH, S, W, Dh, scale, seed, group_rows, thresh,
                  inv_keep, dropout, stream);
}
