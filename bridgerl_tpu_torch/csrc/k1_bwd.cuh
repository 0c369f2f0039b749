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
// Shapes: q, k, v, dout, dq, dk, dv are (BH, S, Dh) rows wherever their layout
// puts them (k1_tiles.cuh's Head; the fused form writes dq, dk and dv into the
// column blocks of one (B, S, 3d) buffer), all float32 (entry point
// packed_attention_bwd) or all bfloat16
// (packed_attention_bwd_bf16); bias is (S, S) float32 in both, read only
// inside the diagonal (W, W) blocks. Everything inside is float32, and dq,
// dk and dv are rounded to bfloat16 once, as they are stored. W divides S.
// Dh is any of 1 to 128, staged at 16, 32, 64, 96 or 128 (as the forward:
// the ragged form below the width). Element (i, j)
// of row r keeps the forward's Philox counter i * S + j, i and j positions
// in the packed row, and the forward's seed groups (group_rows rows a seed,
// philox.cuh). causal states that the bias is the causal bias, as in the
// forward: the long-window path reads none of it above the diagonal and
// skips the tiles wholly above it.
// The two-kernel long-window path takes `stats`, scratch that its first
// kernel writes and its second reads: the p_drop and ds planes of every
// window (the row-buffered dq kernel), or each position's row max,
// 1 / normaliser and rowsum(dp * p) (the two-sweep dq kernel;
// ops/attention.py::backward_scratch).
//
// Only the diagonal blocks, and that is exact: with the model's -1e9 bias
// across windows, every across-window p is exactly 0 in f32, so those
// blocks add exactly 0 to dv, to rowsum(dp * p), and (through ds = p * ...)
// to dq and dk. A window therefore owns every output of its rows and keys:
// dk_j and dv_j sum over the window's W query rows only.
//
// The paths, picked by W and the dtype (ops/attention.py::k1_plan; the
// launcher refuses any other plan):
//
// Window tiles, W < kMinWindow (32), float32. What bounds them: at the
// training shape (256, 80, 64), W = 10, the function moves 7 * 4 * BH * S *
// Dh = 36.7 MB (11 us at 3.35 TB/s) and needs about 10 * BH * S * W * Dh =
// 131 MFLOP (2 us on the float32 cores): 3.6 FLOP a byte, bound by bytes.
// One pass per window: a block of 128 threads takes G = 20 / W consecutive
// windows, copies q, k, v and dout with 16-byte cp.async into padded float32
// rows; one thread per element fetches bias_ij and the keep factor while the
// copies fly; then the logits and do . v in 2 x 2 tiles a thread, the
// softmax, D_i and ds a row a thread, and dq, dk, dv for two rows at one
// 16-byte column a thread, on the float32 cores. No atomics; the phases'
// chain, not the bytes, sets the time (PERF.md). bfloat16 at W < kMinWindow
// takes the multi-window backward of k1_multi.cuh instead (one kernel, on
// the tensor cores).
//
// Long windows, W >= 32 (k1_mma.cuh): about 0.36 W FLOP a byte in float32
// (23 at W 64), so the float32 cores would set the pace; the products run
// on the tensor cores (bf16 operands, float32 ones as three bf16 parts; the
// float32 entry point in 3xTF32, at 495 TFLOP/s for each of the three
// products). No atomics: every output is summed in a fixed order. Windows
// of up to 64 positions, and up to 128 at Dh <= 64 (the towers' W 64, the
// prior's 96 and 128), take one window-resident kernel: five products and
// one Philox draw an element. Longer ones (any W up to S = 65,535) take two
// kernels. What bounds them at the shapes they run (W 160-256, tens to a
// hundred windows) is not the card's rate but latency: at 72-192 blocks of
// four warps, under one block an SM, each warp waits on its mma.sync and
// Philox chains (tools/k1_phases.py: the logits phase 70-84% of a block).
// The design answers with fewer products and draws and more warps where
// 64-row blocks would not fill the card: the row-buffered dq kernel sweeps K
// and V once (the logits and dp of its rows kept in shared memory) where the
// two-sweep kernel swept twice, and hands p_drop and ds to the keys kernel
// through two (W, W) float32 planes a window in device memory (L2-resident
// at these grids), so the keys kernel computes no logits and draws nothing:
// five products and one draw an element in all, as the window-resident
// kernel, where the two-sweep pair takes nine and three. Both take 32 rows
// (keys) a block, each streamed tile split between two warps (twice the
// warps in flight). On a full card (the prior at 256 positions) the row
// buffers would leave one block an SM, and the two-sweep dq kernel's three
// an SM win: it runs there with the dk / dv kernel, as it does where no row
// buffer fits (W past about 500-800). The second kernel is launched as the
// first's programmatic dependent, staging what it can while the first ends.
//
// The entry points are packed_attention_bwd.cu (float32) and
// packed_attention_bwd_bf16.cu (the multi-window kernel of k1_multi.cuh and
// the window-resident kernel), and packed_attention_bwd_long.cu and _bf16_long.cu (the two
// kernels): four libraries that ops/kernels.py builds in parallel, each
// instantiating only its own dtype's and path's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "k1_mma.cuh"
#include "k1_multi.cuh"
#include "k1_tiles.cuh"
#include "philox.cuh"

namespace {

using k1::TileDims;

template <typename Elem, int DH, bool RAGGED, bool SPAN>
__global__ void __launch_bounds__(k1::kTileThreads)
k1_bwd_tiles(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, const float* __restrict__ bias,
             const Elem* __restrict__ dout, Elem* __restrict__ dq,
             Elem* __restrict__ dk, Elem* __restrict__ dv, int S, int W, int G,
             int nwin, float scale, const int* __restrict__ seed_ptr, int group_rows,
             unsigned thresh, float inv_keep, int dropout, k1::Head hd) {
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

  // the block's rows (Divided where they cross from one row n to the next: SPAN)
  const auto rin = k1::block_rows<SPAN>(hd, k1::kIn, (unsigned)n0 * W);
  k1::stage_tile<DH, RAGGED>(qs, q, rin, rows, hd);
  k1::stage_tile<DH, RAGGED>(ks, k, rin, rows, hd);
  k1::stage_tile<DH, RAGGED>(vs, v, rin, rows, hd);
  k1::stage_tile<DH, RAGGED>(os, dout, k1::block_rows<SPAN>(hd, k1::kOut, (unsigned)n0 * W),
                             rows, hd);

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
  const auto rgrad = k1::block_rows<SPAN>(hd, k1::kGrad, (unsigned)n0 * W);
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
    Elem* out = dq + rgrad(r0) + 4 * c;
    k1::put4<RAGGED>(out, 4 * c, x0, hd);
    if (a0 + 1 < W) k1::put4<RAGGED>(out + hd.grad.pos, 4 * c, x1, hd);   // same window
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
    const size_t at = rgrad(top + a0) + 4 * c;
    k1::put4<RAGGED>(dk + at, 4 * c, k0, hd);
    k1::put4<RAGGED>(dv + at, 4 * c, v0, hd);
    if (a0 + 1 < W) {   // the next position of the same window
      k1::put4<RAGGED>(dk + at + hd.grad.pos, 4 * c, k1v, hd);
      k1::put4<RAGGED>(dv + at + hd.grad.pos, 4 * c, v1, hd);
    }
  }
}

// The two-kernel path (W past the window-resident kernel; k1_mma.cuh), no
// atomics. The two-sweep dq kernel, for windows whose row buffers would not
// fit (the row-buffered kernel below takes the rest): block (window n, query
// tile qt) owns kRows query rows, 16 a warp, with their q and dout in shared
// memory, and streams K and V in double-buffered tiles of kCols keys, twice.
// Sweep 1 computes the logits and dp = keep * (dout v^T) / keep_prob on the
// tensor cores and keeps, per row, the running max m, l = sum_j e_ij and
// sum_j e_ij dp_ij (e_ij = expf(s_ij - m), rescaled as m grows); then D =
// that sum / l. Sweep 2 recomputes them, forms p = e / l and ds = p (dp - D)
// * scale, and adds ds k on the tensor cores; dq is stored once. The rows'
// m, 1 / l and D go to a scratch array (3 floats a position). The dk / dv
// kernel: block (window n, key tile kt) owns kRows keys, 16 a warp, with
// their k and v in shared memory, and streams q, dout and the rows'
// statistics in tiles of kCols queries; a warp computes s^T = k q^T and dp^T
// = v dout^T for its keys, p^T = expf(s^T - m_i) / l_i, the keep bits, ds^T,
// and adds p_drop^T dout to dv and ds^T q to dk, each stored once. Every
// sum runs in a fixed order, so dq, dk and dv are the same on every launch.
// Under causal, the dq kernel skips the key tiles past its last query and the
// dk / dv kernel the query tiles before its first key.
template <typename Elem, int DH, bool RAGGED>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_mma_dq(const Elem* __restrict__ q, const Elem* __restrict__ k,
              const Elem* __restrict__ v, const float* __restrict__ bias,
              const Elem* __restrict__ dout, Elem* __restrict__ dq, float* __restrict__ stats,
              int S, int W, int qtiles, size_t positions, float scale,
              const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
              float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int LS = MmaTile<Elem, DH>::LS, NT = kCols / 8;
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // kRows x LS
  Elem* os = qs + kRows * LS;                   // dout, kRows x LS
  Elem* kvs = os + kRows * LS;                  // 2 stages of (K, V), kCols x LS each

  const int n = blockIdx.x / qtiles, qt = blockIdx.x - n * qtiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int i0 = qt * kRows;
  const Strided rin = window_rows(hd, kIn, n, W), rout = window_rows(hd, kOut, n, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = i0 + warp * 16 + (lane >> 2);
  const int nk = key_tiles(W, qt, causal);
  K1_PHASE_BEGIN();
  unsigned seed = 0, prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }

  stage_mma<Elem, DH, RAGGED>(qs, q, rin.from(i0), kRows, W - i0, q, hd);
  stage_mma<Elem, DH, RAGGED>(os, dout, rout.from(i0), kRows, W - i0, dout, hd);
  stage_mma<Elem, DH, RAGGED>(kvs, k, rin, kCols, W, k, hd);
  stage_mma<Elem, DH, RAGGED>(kvs + kCols * LS, v, rin, kCols, W, v, hd);
  cp_async_commit();

  float dqa[DH / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
  for (int it = 0; it < 2 * nk; ++it) {   // sweep 1: it < nk; sweep 2: the rest
    const int kt = it < nk ? it : it - nk;
    if (it + 1 < 2 * nk) {
      Elem* nxt = kvs + ((it + 1) & 1) * 2 * kCols * LS;
      const int j1 = (it + 1 < nk ? it + 1 : it + 1 - nk) * kCols;
      stage_mma<Elem, DH, RAGGED>(nxt, k, rin.from(j1), kCols, W - j1, k, hd);
      stage_mma<Elem, DH, RAGGED>(nxt + kCols * LS, v, rin.from(j1), kCols, W - j1,
                                  v, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* ks = kvs + (it & 1) * 2 * kCols * LS;
    const Elem* vs = ks + kCols * LS;
    if (it == nk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        il[h] = 1.f / quad_sum(l[h]);
        D[h] = quad_sum(dn[h]) * il[h];
      }
    }

    float s[NT][4] = {}, dp[NT][4] = {};
    gemm_nt<NT, DH>(s, qs + warp * 16 * LS, ks, lane);
    gemm_nt<NT, DH>(dp, os + warp * 16 * LS, vs, lane);
    float mx[2] = {m[0], m[1]};
    const unsigned long long keep =
        dropout ? keep_bits(seed, prow, S, w0, W, ra, kt * kCols, NT, causal, thresh, false,
                            lane)
                : 0ull;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ra + 8 * (e >> 1), j = kt * kCols + c * 8 + 2 * t + (e & 1);
        float x;
        if (j >= W || (causal && j > i))
          x = -INFINITY;
        else
          x = i < W ? s[c][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j)
                    : s[c][e] * scale;
        s[c][e] = x;
        if (dropout) dp[c][e] = (keep >> (4 * c + e)) & 1ull ? dp[c][e] * inv_keep : 0.f;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    if (it < nk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        const float corr = __expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr;
        dn[h] *= corr;
      }
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[c][e] - m[e >> 1]);
          l[e >> 1] += p;
          dn[e >> 1] = fmaf(p, dp[c][e], dn[e >> 1]);
        }
      K1_PHASE(1);
    } else {
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = __expf(s[c][e] - m[h]) * il[h];
          s[c][e] = p * (dp[c][e] - D[h]) * scale;
        }
      K1_PHASE(1);
      gemm_pv<NT, DH>(dqa, s, ks, lane);
      K1_PHASE(2);
    }
    __syncthreads();
  }
  const Strided rgrad = window_rows(hd, kGrad, n, W);   // built where used
  store_rows<Elem, DH, DH / 8, RAGGED>(dq, rgrad, dqa, ra, W, 1.f, 1.f, lane, hd);
  if (t == 0) {
    const size_t at = (size_t)row * S + w0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ra + 8 * h;
      if (i < W) {
        stats[at + i] = m[h];
        stats[positions + at + i] = il[h];
        stats[2 * positions + at + i] = D[h];
      }
    }
  }
  K1_PHASE(3);
  K1_PHASE_END(0);
}

template <typename Elem, int DH, bool RAGGED>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_mma_dkv(const Elem* __restrict__ q, const Elem* __restrict__ k,
               const Elem* __restrict__ v, const float* __restrict__ bias,
               const Elem* __restrict__ dout, Elem* __restrict__ dk, Elem* __restrict__ dv,
               const float* __restrict__ stats, int S, int W, int ktiles, size_t positions,
               float scale, const int* __restrict__ seed_ptr, int group_rows,
               unsigned thresh, float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int LS = MmaTile<Elem, DH>::LS, RB = kRows, NT = kCols / 8, NO = DH / 8;
  extern __shared__ float4 smem4[];
  Elem* ks = reinterpret_cast<Elem*>(smem4);   // RB x LS
  Elem* vs = ks + RB * LS;
  Elem* qos = vs + RB * LS;                     // 2 stages of (q, dout), kCols x LS each
  float* sts = reinterpret_cast<float*>(qos + 4 * kCols * LS);   // 2 stages of (m, 1/l, D)

  const int n = blockIdx.x / ktiles, kt = blockIdx.x - n * ktiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int j0 = kt * RB;
  const Strided rin = window_rows(hd, kIn, n, W), rout = window_rows(hd, kOut, n, W);
  const size_t at = (size_t)row * S + w0;       // the window's first position in stats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ja = j0 + warp * 16 + (lane >> 2);  // the thread's keys: ja and ja + 8
  const int nq = (W + kCols - 1) / kCols, q0 = first_query_tile(kt, causal, RB);
  K1_PHASE_BEGIN();
  unsigned seed = 0, prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }

  auto stage_queries = [&](int qi, int buf) {
    Elem* dst = qos + buf * 2 * kCols * LS;
    const int i1 = qi * kCols;
    stage_mma<Elem, DH, RAGGED>(dst, q, rin.from(i1), kCols, W - i1, q, hd);
    stage_mma<Elem, DH, RAGGED>(dst + kCols * LS, dout, rout.from(i1), kCols,
                                W - i1, dout, hd);
    for (int e = threadIdx.x; e < 3 * kCols; e += kMmaThreads) {
      const int a = e / kCols, i = e - a * kCols;
      const bool ok = i1 + i < W;
      cp_async4_zfill(sts + (buf * 3 + a) * kCols + i,
                      ok ? stats + a * positions + at + i1 + i : stats, ok);
    }
  };
  stage_mma<Elem, DH, RAGGED>(ks, k, rin.from(j0), RB, W - j0, k, hd);
  stage_mma<Elem, DH, RAGGED>(vs, v, rin.from(j0), RB, W - j0, v, hd);
  // launched as the dq kernel's dependent: its keys are staged while the dq
  // kernel ends, and nothing of the statistics is read before it has
  asm volatile("griddepcontrol.wait;" ::: "memory");
  stage_queries(q0, 0);
  cp_async_commit();

  float dka[NO][4] = {}, dva[NO][4] = {};
  for (int qi = q0; qi < nq; ++qi) {
    const int buf = (qi - q0) & 1;
    if (qi + 1 < nq) stage_queries(qi + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* qt_ = qos + buf * 2 * kCols * LS;
    const Elem* ot = qt_ + kCols * LS;
    const float* st = sts + buf * 3 * kCols;

    float s[NT][4] = {}, dp[NT][4] = {};
    gemm_nt<NT, DH>(s, ks + warp * 16 * LS, qt_, lane);
    gemm_nt<NT, DH>(dp, vs + warp * 16 * LS, ot, lane);
    const unsigned long long keep =
        dropout ? keep_bits(seed, prow, S, w0, W, ja, qi * kCols, NT, causal, thresh, true,
                            lane)
                : 0ull;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = c * 8 + 2 * t + (e & 1);      // query, within the tile
        const int i = qi * kCols + li, j = ja + 8 * (e >> 1);
        float p = 0.f, ds = 0.f;
        if (i < W && j < W && !(causal && j > i)) {
          const float x = s[c][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j);
          p = __expf(x - st[li]) * st[kCols + li];
          const bool kept = !dropout || ((keep >> (4 * c + e)) & 1ull);
          const float g = !dropout ? dp[c][e] : kept ? dp[c][e] * inv_keep : 0.f;
          ds = p * (g - st[2 * kCols + li]) * scale;
          p = !dropout ? p : kept ? p * inv_keep : 0.f;
        }
        s[c][e] = p;    // p_drop
        dp[c][e] = ds;
      }
    K1_PHASE(1);
    gemm_pv<NT, DH>(dva, s, ot, lane);
    gemm_pv<NT, DH>(dka, dp, qt_, lane);
    K1_PHASE(2);
    __syncthreads();
  }
  const Strided rgrad = window_rows(hd, kGrad, n, W);   // built where used
  store_rows<Elem, DH, DH / 8, RAGGED>(dv, rgrad, dva, ja, W, 1.f, 1.f, lane, hd);
  store_rows<Elem, DH, DH / 8, RAGGED>(dk, rgrad, dka, ja, W, 1.f, 1.f, lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(1);
}

// The row-buffered dq kernel (the two-kernel path's first kernel where blocks
// of 64 rows would not fill the card and its buffers fit: k1_mma.cuh's
// bwd_block_rows). Block (window n, query tile qt) owns RB = 32 query rows
// with their q and dout in shared memory, and
// streams K and V in double-buffered tiles of kCols keys once: each warp takes
// 16 rows and a 32 / KP-key part of the tile, computes s = q k^T and
// dp = dout v^T on the tensor cores, its keep bits, and writes the logits
// (scale and bias added; -inf past the window and above a causal diagonal),
// keep * dp / keep_prob into (RB, keys) float32 buffers in shared memory and
// the keep flags into a bit mask. Then 128 / RB threads a row take the row's max m, l = sum_j expf(x
// - m), D = sum_j p dp with p = expf(x - m) / l, and ds = p (dp - D) * scale,
// each in a fixed order; ds stays in the buffer, and p_drop and ds go to two
// (W, W) float32 planes a window in device memory (row stride
// bwd_plane_stride), from which the keys kernel below takes dk and dv. Last,
// K streams again (its first tile fetched while the rows are reduced) and
// each warp adds ds k for 16 rows and a 1 / KP share of dq's columns, stored
// once. With the keys kernel's two products: five products and one Philox
// draw an element, as the window-resident kernel, where the two-sweep kernel
// and the dk / dv kernel take nine and three.
template <typename Elem, int DH, bool RAGGED>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_mma_rows(const Elem* __restrict__ q, const Elem* __restrict__ k,
                const Elem* __restrict__ v, const float* __restrict__ bias,
                const Elem* __restrict__ dout, Elem* __restrict__ dq, float* __restrict__ pd,
                int S, int W, int qtiles, size_t plane, float scale,
                const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
                float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int LS = MmaTile<Elem, DH>::LS, RB = kRows / 2, RG = RB / 16, KP = kMmaWarps / RG;
  constexpr int NTW = kCols / 8 / KP, NO = DH / 8, NOW = NO / KP, TPR = kMmaThreads / RB;
  static_assert(RG * KP == kMmaWarps && NO % KP == 0, "two warps a streamed tile");
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // RB x LS
  Elem* os = qs + RB * LS;                      // dout, RB x LS
  Elem* kvs = os + RB * LS;                     // 2 stages of (K, V), kCols x LS each
  const int BS = bwd_buffer_stride(W);
  float* xs = reinterpret_cast<float*>(kvs + 4 * kCols * LS);   // RB x BS: logits, p, ds
  float* gs = xs + RB * BS;                                     // RB x BS: dp
  // keep flags: bit j % 32 of word (row, j / 32), RB x NKW words
  const int NKW = (W + kCols - 1) / kCols;
  unsigned* kw = reinterpret_cast<unsigned*>(gs + RB * BS);

  const int n = blockIdx.x / qtiles, qt = blockIdx.x - n * qtiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int i0 = qt * RB;
  const Strided rin = window_rows(hd, kIn, n, W), rout = window_rows(hd, kOut, n, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rg = warp % RG, part = warp / RG, c0 = part * 8 * NTW;
  const int lr = rg * 16 + (lane >> 2);   // the thread's rows in the block: lr and lr + 8
  const int ra = i0 + lr;
  const int nk = key_tiles(W, qt, causal, RB);
  K1_PHASE_BEGIN();
  unsigned seed = 0, prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }

  stage_mma<Elem, DH, RAGGED>(qs, q, rin.from(i0), RB, W - i0, q, hd);
  stage_mma<Elem, DH, RAGGED>(os, dout, rout.from(i0), RB, W - i0, dout, hd);
  stage_mma<Elem, DH, RAGGED>(kvs, k, rin, kCols, W, k, hd);
  stage_mma<Elem, DH, RAGGED>(kvs + kCols * LS, v, rin, kCols, W, v, hd);
  cp_async_commit();
  // under causal, the warp's column tiles that reach its last row
  const int last = i0 + rg * 16 + 15;
  for (int kt = 0; kt < nk; ++kt) {
    Elem* nxt = kvs + ((kt + 1) & 1) * 2 * kCols * LS;
    if (kt + 1 < nk) {
      const int j1 = (kt + 1) * kCols;
      stage_mma<Elem, DH, RAGGED>(nxt, k, rin.from(j1), kCols, W - j1, k, hd);
      stage_mma<Elem, DH, RAGGED>(nxt + kCols * LS, v, rin.from(j1), kCols, W - j1,
                                  v, hd);
    } else {
      stage_mma<Elem, DH, RAGGED>(nxt, k, rin, kCols, W, k, hd);   // the dq products' 1st K tile
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* ks = kvs + (kt & 1) * 2 * kCols * LS + c0 * LS;   // the warp's keys
    const Elem* vs = ks + kCols * LS;
    const int j00 = kt * kCols + c0;
    const int c_end = !causal ? NTW : last < j00 ? 0 : min(NTW, (last - j00) / 8 + 1);

    float s[NTW][4] = {}, dp[NTW][4] = {};
    gemm_nt<NTW, DH>(s, qs + rg * 16 * LS, ks, lane, c_end);
    gemm_nt<NTW, DH>(dp, os + rg * 16 * LS, vs, lane, c_end);
    const unsigned long long keep =
        dropout ? keep_bits(seed, prow, S, w0, W, ra, j00, c_end, causal, thresh, false, lane)
                : 0ull;
    unsigned kb[2] = {0u, 0u};   // rows lr and lr + 8: the flags of the warp's 8 NTW keys
#pragma unroll
    for (int c = 0; c < NTW; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ra + 8 * h;
        float x[2], gd[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int e = 2 * h + b, j = j00 + c * 8 + 2 * t + b;
          if (j >= W || (causal && j > i))
            x[b] = -INFINITY;
          else
            x[b] = i < W ? s[c][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j)
                         : s[c][e] * scale;   // a row past the window: never stored
          gd[b] = !dropout ? dp[c][e] : (keep >> (4 * c + e)) & 1ull ? dp[c][e] * inv_keep : 0.f;
        }
        const int off = (lr + 8 * h) * BS + j00 + c * 8 + 2 * t;
        *reinterpret_cast<float2*>(xs + off) = make_float2(x[0], x[1]);
        *reinterpret_cast<float2*>(gs + off) = make_float2(gd[0], gd[1]);
        kb[h] |= (unsigned)((keep >> (4 * c + 2 * h)) & 3ull) << (8 * c + 2 * t);
      }
    if (dropout) {   // the 4 lanes of a row hold its flags between them
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kb[h] |= __shfl_xor_sync(0xffffffffu, kb[h], 1);
        kb[h] |= __shfl_xor_sync(0xffffffffu, kb[h], 2);
        if (t == 0)   // the warp's half (8 NTW = 16 keys) of the tile's word
          reinterpret_cast<unsigned short*>(kw + (lr + 8 * h) * NKW + kt)[part] =
              (unsigned short)kb[h];
      }
    }
    K1_PHASE(1);
    __syncthreads();
  }

  {   // the rows: TPR adjacent threads a row, each over every TPR-th key
    const int r = threadIdx.x / TPR, p0 = threadIdx.x - r * TPR, ncol = nk * kCols;
    float* xr = xs + r * BS;
    const float* gr = gs + r * BS;
    const unsigned* kwr = kw + r * NKW;
    float m = -INFINITY;
    for (int j = p0; j < ncol; j += TPR) m = fmaxf(m, xr[j]);
    m = lanes_max<TPR>(m);
    float l = 0.f;
    for (int j = p0; j < ncol; j += TPR) {
      const float e = __expf(xr[j] - m);
      xr[j] = e;
      l += e;
    }
    const float il = 1.f / lanes_sum<TPR>(l);
    float D = 0.f;
    for (int j = p0; j < ncol; j += TPR) D = fmaf(gr[j], xr[j] * il, D);
    D = lanes_sum<TPR>(D);
    const int i = i0 + r;
    // the row's p_drop and ds, row-major in the window's planes for the keys
    // kernel (rows past the window are not stored)
    float* pdr = pd + ((size_t)n * W + i) * bwd_plane_stride(W);
    for (int j = p0; j < ncol; j += TPR) {
      const float p = xr[j] * il;
      const float ds = i < W ? p * (gr[j] - D) * scale : 0.f;
      xr[j] = ds;
      if (i < W) {
        pdr[j] = !dropout || (kwr[j >> 5] >> (j & 31)) & 1u ? p * inv_keep : 0.f;
        pdr[plane + j] = ds;
      }
    }
  }
  // the keys kernel may be scheduled now (it waits for this grid's end before
  // it reads the planes)
  asm volatile("griddepcontrol.launch_dependents;");
  K1_PHASE(2);

  // dq = ds k: the warp's 16 rows and NOW tiles of 8 columns from column c8
  const int c8 = part * NOW * 8;
  float acc[NOW][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int j1 = (kt + 1) * kCols;
      stage_mma<Elem, DH, RAGGED>(kvs + ((nk + kt + 1) & 1) * 2 * kCols * LS,
                                  k, rin.from(j1), kCols, W - j1, k, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* ks = kvs + ((nk + kt) & 1) * 2 * kCols * LS;
    float p[kCols / 8][4];
#pragma unroll
    for (int c = 0; c < kCols / 8; ++c) {
      const float* at = xs + lr * BS + kt * kCols + c * 8 + 2 * t;
      const float2 a = *reinterpret_cast<const float2*>(at);
      const float2 b = *reinterpret_cast<const float2*>(at + 8 * BS);
      p[c][0] = a.x;
      p[c][1] = a.y;
      p[c][2] = b.x;
      p[c][3] = b.y;
    }
    gemm_pv<kCols / 8, DH, NOW>(acc, p, ks + c8, lane);
    K1_PHASE(3);
    __syncthreads();
  }
  const Strided rgrad = window_rows(hd, kGrad, n, W);   // built where used
  store_rows<Elem, DH, NOW, RAGGED>(dq + c8, rgrad, acc, ra, W, 1.f, 1.f, lane, hd, c8);
  K1_PHASE_END(0);
}

// The keys kernel (with the row-buffered dq kernel): block (window n, key
// tile kt) owns RB = kRows / 2 keys, 16 a warp, and streams q, dout and the
// dq kernel's p_drop and ds planes in double-buffered tiles of kCols queries
// (only those on and below a causal diagonal), each tile split between two
// warps; a warp reads its (16 keys, 16 queries) parts of p_drop^T and ds^T
// from the staged tiles by columns, adds p_drop^T dout to dv and ds^T q to
// dk, and the two parts' sums are added in part order; each output is
// stored once. No logits, softmax or draws: two products an element.
template <typename Elem, int DH, bool RAGGED>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_mma_keys(const Elem* __restrict__ q, const Elem* __restrict__ dout,
                Elem* __restrict__ dk, Elem* __restrict__ dv, const float* __restrict__ pd,
                int W, int ktiles, size_t plane, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int RB = kRows / 2, RG = RB / 16, KP = kMmaWarps / RG, NTW = kCols / 8 / KP;
  constexpr int LS = MmaTile<Elem, DH>::LS, NO = DH / 8, PS = RB + 4;
  static_assert(RG * KP == kMmaWarps && NTW % 2 == 0, "two warps a streamed tile");
  extern __shared__ float4 smem4[];
  Elem* qos = reinterpret_cast<Elem*>(smem4);   // 2 stages of (q, dout), kCols x LS each
  float* pts = reinterpret_cast<float*>(qos + 4 * kCols * LS);   // 2 stages of (p_drop, ds),
                                                                  // kCols queries x PS
  const int n = blockIdx.x / ktiles, kt = blockIdx.x - n * ktiles;
  const int j0 = kt * RB, WP = bwd_plane_stride(W);
  const Strided rin = window_rows(hd, kIn, n, W), rout = window_rows(hd, kOut, n, W);
  const float* pdw = pd + (size_t)n * W * WP;   // the window's p_drop plane; ds at + plane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, part = warp / RG, c0 = part * 8 * NTW;
  const int ja = j0 + rg * 16 + g;   // the thread's keys: ja and ja + 8
  const int nq = (W + kCols - 1) / kCols, q0 = first_query_tile(kt, causal, RB);
  K1_PHASE_BEGIN();

  auto stage_rows = [&](int qi, int buf) {
    Elem* dst = qos + buf * 2 * kCols * LS;
    const int i1 = qi * kCols;
    stage_mma<Elem, DH, RAGGED>(dst, q, rin.from(i1), kCols, W - i1, q, hd);
    stage_mma<Elem, DH, RAGGED>(dst + kCols * LS, dout, rout.from(i1), kCols,
                                W - i1, dout, hd);
  };
  auto stage_planes = [&](int qi, int buf) {   // rows i1 .. i1 + 31, keys j0 .. j0 + RB - 1
    const int i1 = qi * kCols;
    for (int e = threadIdx.x; e < 2 * kCols * (RB / 4); e += kMmaThreads) {
      const int a = e / (kCols * (RB / 4)), r = (e / (RB / 4)) % kCols, c = e % (RB / 4);
      const bool ok = i1 + r < W;
      cp_async16_zfill(pts + ((buf * 2 + a) * kCols + r) * PS + 4 * c,
                       ok ? pdw + a * plane + (size_t)(i1 + r) * WP + j0 + 4 * c : pd, ok);
    }
  };
  stage_rows(q0, 0);
  // launched as the dq kernel's dependent: q and dout are staged while it ends,
  // and nothing of its planes is read before it has
  asm volatile("griddepcontrol.wait;" ::: "memory");
  stage_planes(q0, 0);
  cp_async_commit();

  float dka[NO][4] = {}, dva[NO][4] = {};
  for (int qi = q0; qi < nq; ++qi) {
    const int buf = (qi - q0) & 1;
    if (qi + 1 < nq) {
      stage_rows(qi + 1, buf ^ 1);
      stage_planes(qi + 1, buf ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* qt_ = qos + buf * 2 * kCols * LS + c0 * LS;   // the warp's queries
    const Elem* ot = qt_ + kCols * LS;
    float pf[NTW][4], sf[NTW][4];   // p_drop^T and ds^T, (key, query) by columns
#pragma unroll
    for (int c = 0; c < NTW; ++c) {
      const float* at = pts + (buf * 2 * kCols + c0 + c * 8 + 2 * t) * PS + rg * 16 + g;
      pf[c][0] = at[0];
      pf[c][1] = at[PS];
      pf[c][2] = at[8];
      pf[c][3] = at[PS + 8];
      at += kCols * PS;
      sf[c][0] = at[0];
      sf[c][1] = at[PS];
      sf[c][2] = at[8];
      sf[c][3] = at[PS + 8];
    }
    K1_PHASE(1);
    gemm_pv<NTW, DH>(dva, pf, ot, lane);
    gemm_pv<NTW, DH>(dka, sf, qt_, lane);
    K1_PHASE(2);
    __syncthreads();
  }
  // the query parts' sums, added in part order through the (now idle) stage buffers
  float* red = reinterpret_cast<float*>(qos) + rg * 2 * NO * 4 * 32 + lane;
  if (part == 1) {
#pragma unroll
    for (int c = 0; c < NO; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(c * 4 + e) * 32] = dva[c][e];
        red[((NO + c) * 4 + e) * 32] = dka[c][e];
      }
  }
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dva[c][e] += red[(c * 4 + e) * 32];
      dka[c][e] += red[((NO + c) * 4 + e) * 32];
    }
  const Strided rgrad = window_rows(hd, kGrad, n, W);   // built where used
  store_rows<Elem, DH, DH / 8, RAGGED>(dv, rgrad, dva, ja, W, 1.f, 1.f, lane, hd);
  store_rows<Elem, DH, DH / 8, RAGGED>(dk, rgrad, dka, ja, W, 1.f, 1.f, lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(1);
}

// Windows of up to 64 positions at any head dim, and up to 128 at Dh <= 64
// (k1_mma.cuh's bwd_window_rows): one block of NW warps (4 for W <= 64, 8 up
// to 128) owns the whole window, R = 16 NW rows, and computes dq, dk and dv in one
// pass, with five products and one Philox draw an element. q, k, v and dout
// of the window are staged once. Warp w takes query rows 16w .. 16w + 15:
// s = q k^T and dp = dout v^T over the window's keys in registers, the
// row's softmax, D and ds = p (dp - D) * scale, then dq = ds k. Then warp w
// takes keys 16w .. 16w + 15: p_drop goes through one shared (R, R + 4)
// tile, which the warp reads by columns as a register tile (transposed on
// the load) for dv = p_drop^T dout; then ds, kept in registers meanwhile,
// goes through the same tile for dk = ds^T q. Under causal the 8-wide
// column tiles wholly above the diagonal are neither computed nor read, and
// no bias above the diagonal is read.
template <typename Elem, int DH, int NW, bool RAGGED>
__global__ void __launch_bounds__(32 * NW)
k1_bwd_mma_window(const Elem* __restrict__ q, const Elem* __restrict__ k,
                  const Elem* __restrict__ v, const float* __restrict__ bias,
                  const Elem* __restrict__ dout, Elem* __restrict__ dq, Elem* __restrict__ dk,
                  Elem* __restrict__ dv, int S, int W, float scale,
                  const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
                  float inv_keep, int dropout, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int R = 16 * NW, LS = MmaTile<Elem, DH>::LS, NT = R / 8, PS = R + 4;
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // R x LS each
  Elem* ks = qs + R * LS;
  Elem* vs = ks + R * LS;
  Elem* os = vs + R * LS;
  float* pt = reinterpret_cast<float*>(os + R * LS);   // R x PS: p_drop, then ds

  const int n = blockIdx.x, nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const Strided rin = window_rows(hd, kIn, n, W), rout = window_rows(hd, kOut, n, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = warp * 16 + (lane >> 2);   // the thread's rows (queries, then keys)
  // under causal: the column tiles that reach the warp's last query, and the
  // first one that reaches its first key
  const int c_end = causal ? min(NT, 2 * warp + 2) : NT, c_begin = causal ? 2 * warp : 0;
  K1_PHASE_BEGIN();
  unsigned seed = 0, prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }
  stage_mma<Elem, DH, RAGGED>(qs, q, rin, R, W, q, hd);
  stage_mma<Elem, DH, RAGGED>(ks, k, rin, R, W, k, hd);
  stage_mma<Elem, DH, RAGGED>(vs, v, rin, R, W, v, hd);
  stage_mma<Elem, DH, RAGGED>(os, dout, rout, R, W, dout, hd);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  K1_PHASE(0);

  float s[NT][4] = {}, dp[NT][4] = {};
  gemm_nt<NT, DH>(s, qs + warp * 16 * LS, ks, lane, c_end);
  gemm_nt<NT, DH>(dp, os + warp * 16 * LS, vs, lane, c_end);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ra + 8 * (e >> 1), j = c * 8 + 2 * t + (e & 1);
      float x;
      if (j >= W || (causal && j > i))
        x = -INFINITY;
      else
        x = i < W ? s[c][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j)
                  : s[c][e] * scale;   // a row past the window: computed, never used
      s[c][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[c][e] = __expf(s[c][e] - m[e >> 1]);
      l[e >> 1] += s[c][e];
    }
  float il[2], D[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) il[h] = 1.f / quad_sum(l[h]);
  // the thread's keep bits, element (c, e) at bit 4c + e
  const unsigned long long keep =
      dropout ? keep_bits(seed, prow, S, w0, W, ra, 0, c_end, causal, thresh, false, lane)
              : 0ull;
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = s[c][e] * il[h];
      const float gd = !dropout ? dp[c][e] : (keep >> (4 * c + e)) & 1ull ? dp[c][e] * inv_keep
                                                                           : 0.f;
      s[c][e] = p;
      dp[c][e] = gd;
      D[h] = fmaf(p, gd, D[h]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) D[h] = quad_sum(D[h]);
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, i = ra + 8 * h;
      const float p = s[c][e];
      dp[c][e] = i < W ? p * (dp[c][e] - D[h]) * scale : 0.f;   // ds
      s[c][e] = i >= W ? 0.f : !dropout ? p : (keep >> (4 * c + e)) & 1ull ? p * inv_keep : 0.f;
    }
  K1_PHASE(1);
  float acc[DH / 8][4] = {};
  gemm_pv<NT, DH>(acc, dp, ks, lane, 0, c_end);
  const Strided rgrad = window_rows(hd, kGrad, n, W);   // built where used
  store_rows<Elem, DH, DH / 8, RAGGED>(dq, rgrad, acc, ra, W, 1.f, 1.f, lane, hd);

  // the warp's rows of a (R, R) register tile into the shared tile, and the
  // warp's keys' columns of it back as a register tile (element (key r,
  // query c) is the shared tile's row c, column r)
  const auto put = [&](const float (&tile)[NT][4]) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      float* at = pt + ra * PS + c * 8 + 2 * t;
      *reinterpret_cast<float2*>(at) = make_float2(tile[c][0], tile[c][1]);
      *reinterpret_cast<float2*>(at + 8 * PS) = make_float2(tile[c][2], tile[c][3]);
    }
  };
  const auto columns = [&](float (&tile)[NT][4]) {
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c < c_begin) continue;
      const float* at = pt + (c * 8 + 2 * t) * PS + ra;
      tile[c][0] = at[0];
      tile[c][1] = at[PS];
      tile[c][2] = at[8];
      tile[c][3] = at[PS + 8];
    }
  };
  put(s);
  __syncthreads();
  K1_PHASE(2);
  columns(s);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  gemm_pv<NT, DH>(acc, s, os, lane, c_begin, NT);
  store_rows<Elem, DH, DH / 8, RAGGED>(dv, rgrad, acc, ra, W, 1.f, 1.f, lane, hd);
  __syncthreads();
  put(dp);
  __syncthreads();
  columns(dp);
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  gemm_pv<NT, DH>(acc, dp, qs, lane, c_begin, NT);
  store_rows<Elem, DH, DH / 8, RAGGED>(dk, rgrad, acc, ra, W, 1.f, 1.f, lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

template <typename Elem, int DH, int NW, bool RAGGED>
int launch_window(const Elem* q, const Elem* k, const Elem* v, const float* bias,
                  const Elem* dout, Elem* dq, Elem* dk, Elem* dv, int S, int W, float scale,
                  const int* seed, int group_rows, unsigned thresh, float inv_keep, int dropout,
                  int causal, int blocks, int smem, k1::Head hd, cudaStream_t stream) {
  const cudaError_t e = k1::allow_smem(k1_bwd_mma_window<Elem, DH, NW, RAGGED>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_bwd_mma_window<Elem, DH, NW, RAGGED><<<blocks, 32 * NW, smem, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, S, W, scale, seed, group_rows, thresh, inv_keep,
      dropout, causal, hd);
  return (int)cudaGetLastError();
}

// The launch plan's numbers: path 0 (window tiles, float32), 3 (the multi-window
// backward, bfloat16; k1_multi.cuh) or 1 (long windows), the blocks and shared memory
// of the first kernel (tiles, multi-window, the window-resident kernel, or dq) and of
// the dk / dv kernel (0 on the one-kernel paths). The
// caller's plan must equal them. The one-kernel paths (launch_one) and the
// two-kernel path (launch_two) are entry points of their own libraries, so
// that nvcc builds them in parallel: each refuses the other's plans. DH is
// the staged width, hd the true head dim (RAGGED where they differ).
template <typename Elem, int DH, bool RAGGED>
int launch_one(const Elem* q, const Elem* k, const Elem* v, const float* bias,
               const Elem* dout, Elem* dq, Elem* dk, Elem* dv, float* stats, int BH, int S,
               int W, float scale, const int* seed, int group_rows, unsigned thresh,
               float inv_keep, int dropout, int causal, int path, int blocks, int smem_bytes,
               int blocks_kv, int smem_kv, k1::Head hd, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  if constexpr (std::is_same_v<Elem, __nv_bfloat16>) {
    if (W < k1::kMinWindow)
      return k1::launch_multi_bwd<DH, RAGGED>(q, k, v, bias, dout, dq, dk, dv, BH, S, W, scale,
                                              seed, group_rows, thresh, inv_keep, dropout,
                                              causal, path, blocks, smem_bytes, blocks_kv,
                                              smem_kv, hd, stream);
  } else if (W < k1::kMinWindow) {
    constexpr int QS = TileDims<DH>::QS;
    const size_t per_window =
        sizeof(float) * ((size_t)4 * W * QS + 3 * (size_t)W * (W + 1));
    const int G = k1::windows_per_block(per_window, W, nwin);
    if (G < 1 || path != 0 || blocks != (nwin + G - 1) / G ||
        (size_t)smem_bytes != G * per_window || blocks_kv != 0 || smem_kv != 0)
      return (int)cudaErrorInvalidValue;
    const auto kernel = k1::spans_rows(hd, G * W) ? k1_bwd_tiles<Elem, DH, RAGGED, true>
                                                  : k1_bwd_tiles<Elem, DH, RAGGED, false>;
    const cudaError_t e = k1::allow_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, k1::kTileThreads, smem_bytes, stream>>>(
        q, k, v, bias, dout, dq, dk, dv, S, W, G, nwin, scale, seed, group_rows, thresh,
        inv_keep, dropout, hd);
    return (int)cudaGetLastError();
  }
  const int R = k1::bwd_window_rows<DH>(W);   // window-resident rows, or 0: two kernels
  const int smem = R ? k1::bwd_window_smem<Elem, DH>(R) : 0;
  if (!R || path != 1 || blocks != nwin || smem_bytes != smem || blocks_kv != 0 || smem_kv != 0)
    return (int)cudaErrorInvalidValue;
  if constexpr (DH <= 64) {
    if (R == 2 * k1::kRows)
      return launch_window<Elem, DH, 8, RAGGED>(q, k, v, bias, dout, dq, dk, dv, S, W, scale,
                                                seed, group_rows, thresh, inv_keep, dropout,
                                                causal, blocks, smem, hd, stream);
  }
  return launch_window<Elem, DH, 4, RAGGED>(q, k, v, bias, dout, dq, dk, dv, S, W, scale, seed,
                                            group_rows, thresh, inv_keep, dropout, causal,
                                            blocks, smem, hd, stream);
}

// A second kernel launched as the first's programmatic dependent: it stages
// what does not depend on the first while that one ends.
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, int blocks, int smem, cudaStream_t stream,
                             Args... args) {
  cudaError_t e = k1::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(k1::kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dep;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Two kernels (k1_mma.cuh's bwd_block_rows): the row-buffered dq kernel in
// blocks of kRows / 2 rows and the keys kernel, through the p_drop and ds
// planes in `scratch` (2 * BH * (S / W) * W * bwd_plane_stride(W) floats);
// or, on a full card or where no row buffer fits, the two-sweep dq kernel
// and the dk / dv kernel in blocks of kRows, through the rows' statistics in
// `scratch` (3 * BH * S floats, and 4).
template <typename Elem, int DH, bool RAGGED>
int launch_two(const Elem* q, const Elem* k, const Elem* v, const float* bias,
               const Elem* dout, Elem* dq, Elem* dk, Elem* dv, float* scratch, int BH, int S,
               int W, float scale, const int* seed, int group_rows, unsigned thresh,
               float inv_keep, int dropout, int causal, int path, int blocks, int smem_bytes,
               int blocks_kv, int smem_kv, k1::Head hd, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  if (W < k1::kMinWindow || k1::bwd_window_rows<DH>(W) || path != 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int RB = k1::bwd_block_rows<Elem, DH>(nwin, W);
  const int tiles = (W + (RB ? RB : k1::kRows) - 1) / (RB ? RB : k1::kRows);
  const long long smem = RB ? k1::bwd_rows_smem<Elem, DH>(RB, W) : k1::bwd_dq_smem<Elem, DH>();
  const int smem2 = RB ? k1::bwd_keys_smem<Elem, DH>() : k1::bwd_cols_smem<Elem, DH>();
  if ((long long)blocks != (long long)nwin * tiles || blocks_kv != blocks ||
      smem_bytes != smem || smem_kv != smem2)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (RB) {
    const size_t plane = (size_t)nwin * W * k1::bwd_plane_stride(W);
    e = k1::allow_smem(k1_bwd_mma_rows<Elem, DH, RAGGED>, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    k1_bwd_mma_rows<Elem, DH, RAGGED><<<blocks, k1::kMmaThreads, smem_bytes, stream>>>(
        q, k, v, bias, dout, dq, scratch, S, W, tiles, plane, scale, seed, group_rows, thresh,
        inv_keep, dropout, causal, hd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = launch_dependent(k1_bwd_mma_keys<Elem, DH, RAGGED>, blocks_kv, smem2, stream, q, dout,
                         dk, dv, (const float*)scratch, W, tiles, plane, causal, hd);
  } else {
    const size_t positions = (size_t)BH * S;
    e = k1::allow_smem(k1_bwd_mma_dq<Elem, DH, RAGGED>, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    k1_bwd_mma_dq<Elem, DH, RAGGED><<<blocks, k1::kMmaThreads, smem_bytes, stream>>>(
        q, k, v, bias, dout, dq, scratch, S, W, tiles, positions, scale, seed, group_rows,
        thresh, inv_keep, dropout, causal, hd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = launch_dependent(k1_bwd_mma_dkv<Elem, DH, RAGGED>, blocks_kv, smem2, stream, q, k, v,
                         bias, dout, dk, dv, (const float*)scratch, S, W, tiles, positions,
                         scale, seed, group_rows, thresh, inv_keep, dropout, causal, hd);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// kTwo: the two-kernel library's launcher (launch_two), else launch_one; only
// the one a library names is instantiated there.
template <bool kTwo, typename Elem, int DH, bool RAGGED>
int launch(const Elem* q, const Elem* k, const Elem* v, const float* bias, const Elem* dout,
           Elem* dq, Elem* dk, Elem* dv, float* stats, int BH, int S, int W, float scale,
           const int* seed, int group_rows, unsigned thresh, float inv_keep, int dropout,
           int causal, int path, int blocks, int smem_bytes, int blocks_kv, int smem_kv,
           k1::Head hd, cudaStream_t stream) {
  if constexpr (kTwo)
    return launch_two<Elem, DH, RAGGED>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W,
                                        scale, seed, group_rows, thresh, inv_keep, dropout,
                                        causal, path, blocks, smem_bytes, blocks_kv, smem_kv,
                                        hd, stream);
  else
    return launch_one<Elem, DH, RAGGED>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W,
                                        scale, seed, group_rows, thresh, inv_keep, dropout,
                                        causal, path, blocks, smem_bytes, blocks_kv, smem_kv,
                                        hd, stream);
}

// Switches on the staged width (as k1_fwd.cuh's dispatch); the rows' layout and `copy` as
// k1_tiles.cuh's launch_head. A library holds one form, native or (kRagged) ragged, as
// k1_fwd.cuh's.
template <bool kTwo, bool kRagged, typename Elem>
int dispatch(const Elem* q, const Elem* k, const Elem* v, const float* bias, const Elem* dout,
             Elem* dq, Elem* dk, Elem* dv, float* stats, int BH, int S, int W, int Dh, int H,
             long long in_pos, long long in_batch, long long out_pos, long long out_batch,
             long long grad_pos, long long grad_batch, float scale, const int* seed,
             int group_rows, unsigned thresh, float inv_keep, int dropout, int causal, int path,
             int blocks, int smem_bytes, int blocks_kv, int smem_kv, int copy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (W < 1 || S % W != 0 || S > k1::kMaxRow) return (int)cudaErrorInvalidValue;
  if (group_rows < 1 || BH % group_rows != 0) return (int)cudaErrorInvalidValue;
  k1::Head hd;
  if (!k1::launch_head(BH, S, Dh, copy, (int)sizeof(Elem), H, in_pos, in_batch, out_pos,
                       out_batch, grad_pos, grad_batch, {q, k, v, dout, dq, dk, dv}, hd))
    return (int)cudaErrorInvalidValue;
#define K1_BWD(DH_, RAGGED_)                                                                \
  launch<kTwo, Elem, DH_, RAGGED_>(q, k, v, bias, dout, dq, dk, dv, stats, BH, S, W, scale, \
                                   seed, group_rows, thresh, inv_keep, dropout, causal,     \
                                   path, blocks, smem_bytes, blocks_kv, smem_kv, hd, st)
#define K1_WIDTH(DH_) \
  ((Dh == DH_ && copy == 16) == kRagged ? (int)cudaErrorInvalidValue : K1_BWD(DH_, kRagged))
  if (Dh <= 16) return K1_WIDTH(16);
  if (Dh <= 32) return K1_WIDTH(32);
  if (Dh <= 64) return K1_WIDTH(64);
  if (Dh <= 96) return K1_WIDTH(96);
  if (Dh <= 128) return K1_WIDTH(128);
  return (int)cudaErrorInvalidValue;
#undef K1_WIDTH
#undef K1_BWD
}

}  // namespace
