// K1 forward: packed-window attention,
// out = dropout(softmax(q k^T * scale + bias)) v, within windows of W
// positions of each packed row.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149, kernel body _attn_kernel at :51).
// The backward is csrc/k1_bwd.cuh.
//
// Shapes: q, k, v, out are (BH, S, Dh) rows wherever their layout puts them (k1_tiles.cuh's
// Head: contiguous (BH, S, Dh) tensors, or the fused projection's (B, S, 3d) buffer and a
// (B, S, d) out, rows b * H + h), all
// float32 (entry point packed_attention_fwd) or all bfloat16
// (packed_attention_fwd_bf16); bias is (S, S) float32 in both. The logits,
// softmax, dropout and the sums of p v are float32 in both dtypes, and out is
// rounded to bfloat16 once, as it is stored. W divides S; query i attends to
// the keys j of its own window (i / W == j / W) with bias[i * S + j] added,
// and nothing else of bias is read. Dh is any of 1 to 128: the kernels are
// instantiated at the staged widths 16, 32, 64, 96, 128 (a template
// argument), and a Dh below the width runs their ragged form (k1_tiles.cuh:
// rows of Dh, tiles zero-filled past it, stores of the columns below it; the
// form's entry points are libraries of their own, packed_attention*_ragged.cu);
// Dh past 128 runs through k1_wide.cuh. With dropout on,
// element (i, j) of row r (positions in the packed row) is kept when Philox
// word attn_keep_bits(seed, r, i * S + j) < thresh (philox.cuh) and is then
// scaled by inv_keep; the softmax's normaliser sums the probabilities before
// the mask, as the TPU kernel does.
// seed is read from device memory, so drawing it never waits for the card.
// seed holds one value per group of group_rows rows (BH / group_rows groups,
// the seeds of a stacked multi-seed step): row r of group g = r / group_rows
// draws with seed[g] as row r - g * group_rows, so each group gets the mask
// of a launch of its own (philox.cuh); one group is the single-seed launch.
// causal (set by the token prior) states that the bias is
// models/layers.py::causal_bias, 0 on and below the diagonal and -1e9 above:
// the long-window path then reads no bias above the diagonal (-inf there, so
// p is exactly 0, as expf(-1e9 - m) is) and skips the key tiles wholly above
// it; the window tiles read their (W, W) block, which the contract makes the
// causal bias.
//
// Only the diagonal blocks, and that is exact: the model's bias is -1e9
// across windows, so every across-window probability is expf(s - 1e9 - m),
// which is exactly 0 in f32 for any logit the model can produce; those
// blocks add exactly nothing to the softmax sums or to p v. Computing the
// W x W blocks alone does 1/P of the full row's work (P = S / W windows).
//
// The paths, picked by W and the dtype (the launch plan is
// ops/attention.py::k1_plan; the launcher recomputes it and refuses any other):
//
// Window tiles, W < kMinWindow (32; k1_tiles.cuh), float32. What bounds
// them: at the training shape (256, 80, 64), W = 10, the function needs 4 *
// BH * S * W * Dh = 52 MFLOP (0.8 us on the 67 TFLOP/s float32 cores) and
// moves 4 * 4 * BH * S * Dh bytes = 21 MB (6.3 us at 3.35 TB/s): 2.5 FLOP a
// byte, bound by bytes. A block of 128 threads takes G = 20 / W
// consecutive windows (2 at W = 10), their rows from the first's address or,
// where they cross from one (b, h) to the next, each from its own
// (k1_tiles.cuh's Strided and Divided), and copies q, k and v with 16-byte
// cp.async into padded float32 rows; one
// thread per element fetches bias_ij and the keep factor while the copies
// fly; then logits in 2 x 2 tiles a thread, the f32 softmax a row a thread,
// and out = (p v) / l for two rows at one 16-byte column a thread, on the
// float32 cores. The chain of phases, not the bytes, sets their time
// (PERF.md). bfloat16 at W < kMinWindow takes the multi-window kernels of
// k1_multi.cuh instead: several whole windows a block, a warp a strip of 16
// query rows on the tensor cores.
//
// Long windows, W >= 32 (k1_mma.cuh): the work grows with W, W / 4 FLOP a
// byte in float32 (16 at W 64, 32 at W 128) and W / 2 in bf16, past the
// ~20 at which the float32 cores, not memory, set the pace. So the products
// run on the tensor cores: bf16 q k^T exact on bf16 operands, float32
// operands (p) in three bf16 parts (k1_mma.cuh); the float32 entry point
// in 3xTF32, whose FLOPs are three tf32 products each (495 TFLOP/s: 16 us
// of products at (1024, 64, 64), against 20 us of bytes). Tiles of 64 queries a block
// (16 a warp) and 32 keys, with the online softmax, so any W fits one
// block's shared memory and the grid covers (window, query tile).
//
// The entry points are packed_attention.cu (float32) and
// packed_attention_bf16.cu, two libraries that ops/kernels.py builds in
// parallel; each instantiates only its own dtype's kernels.
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
k1_fwd_tiles(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, const float* __restrict__ bias,
             Elem* __restrict__ out, int S, int W, int G, int nwin, float scale,
             const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
             int dropout, k1::Head hd) {
  extern __shared__ float4 smem4[];
  constexpr int QS = TileDims<DH>::QS, D4 = TileDims<DH>::D4;
  const int PS = W + 1;
  const int n0 = blockIdx.x * G;
  const int g = min(G, nwin - n0);
  const int rows = g * W;
  float* qs = reinterpret_cast<float*>(smem4);   // G * W * QS each
  float* ks = qs + G * W * QS;
  float* vs = ks + G * W * QS;
  float* ps = vs + G * W * QS;                   // G * W * PS: logits, then e * keep
  float* kf = ps + G * W * PS;                   // G * W * PS: keep factors
  float* il = kf + G * W * PS;                   // G * W: 1 / softmax normaliser

  // the block's rows (Divided where they cross from one row n to the next: SPAN)
  const auto rin = k1::block_rows<SPAN>(hd, k1::kIn, (unsigned)n0 * W);
  k1::stage_tile<DH, RAGGED>(qs, q, rin, rows, hd);
  k1::stage_tile<DH, RAGGED>(ks, k, rin, rows, hd);
  k1::stage_tile<DH, RAGGED>(vs, v, rin, rows, hd);

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
    const int i1 = min(i0 + 1, W - 1), j1 = min(j0 + 1, W - 1);
    const int top = lw * W;
    const float4* qa = reinterpret_cast<const float4*>(qs + (top + i0) * QS);
    const float4* qb = reinterpret_cast<const float4*>(qs + (top + i1) * QS);
    const float4* ka = reinterpret_cast<const float4*>(ks + (top + j0) * QS);
    const float4* kb = reinterpret_cast<const float4*>(ks + (top + j1) * QS);
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int c = 0; c < D4; ++c) {
      const float4 a0 = qa[c], a1 = qb[c], b0 = ka[c], b1 = kb[c];
      s[0][0] = k1::dot4(a0, b0, s[0][0]);
      s[0][1] = k1::dot4(a0, b1, s[0][1]);
      s[1][0] = k1::dot4(a1, b0, s[1][0]);
      s[1][1] = k1::dot4(a1, b1, s[1][1]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (i0 + a >= W || j0 + b >= W) continue;
        const int at = (top + i0 + a) * PS + j0 + b;
        ps[at] = s[a][b] * scale + ps[at];
      }
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* pr = ps + r * PS;
    float m = -INFINITY;
    for (int j = 0; j < W; ++j) m = fmaxf(m, pr[j]);
    float l = 0.f;
    for (int j = 0; j < W; ++j) {
      const float e = expf(pr[j] - m);
      l += e;
      pr[j] = dropout ? e * kf[r * PS + j] : e;
    }
    il[r] = 1.f / l;
  }
  __syncthreads();

  // out rows i0 and i0 + 1 of a window at one 16-byte column: each v_j
  // read from shared memory feeds both rows
  const auto rout = k1::block_rows<SPAN>(hd, k1::kOut, (unsigned)n0 * W);
  for (int e = threadIdx.x; e < g * T * D4; e += blockDim.x) {
    const int pair = e / D4, c = e - pair * D4;
    const int lw = pair / T, i0 = 2 * (pair - lw * T);
    const int top = lw * W;
    const int r0 = top + i0, r1 = top + min(i0 + 1, W - 1);
    const float* p0 = ps + r0 * PS;
    const float* p1 = ps + r1 * PS;
    const float* vw = vs + top * QS + 4 * c;
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    for (int j = 0; j < W; ++j) {
      const float4 vj = *reinterpret_cast<const float4*>(vw + j * QS);
      a0 = k1::axpy4(p0[j], vj, a0);
      a1 = k1::axpy4(p1[j], vj, a1);
    }
    Elem* o = out + rout(r0) + 4 * c;
    const float s0 = il[r0];
    k1::put4<RAGGED>(o, 4 * c, make_float4(a0.x * s0, a0.y * s0, a0.z * s0, a0.w * s0), hd);
    if (i0 + 1 < W) {   // the next position of the same window
      const float s1 = il[r1];
      k1::put4<RAGGED>(o + hd.out.pos, 4 * c,
                       make_float4(a1.x * s1, a1.y * s1, a1.z * s1, a1.w * s1), hd);
    }
  }
}

// Long-window path (W >= kMinWindow; k1_mma.cuh): block (window n, query
// tile qt) owns kRows query rows, 16 a warp, held in shared memory; K and V
// stream through in double-buffered tiles of kCols keys. Per key tile a warp
// computes its (16, kCols) logits on the tensor cores, adds scale and bias
// (positions past the window, and under causal those above the diagonal,
// are -inf and read no bias), takes the online softmax (running max m and
// sum l a row; the accumulator is rescaled by exp(m_old - m_new); the
// exponentials are __expf, within 2 + 1.2 |x| float32 ulps), draws
// the keep bits of its elements while the next tile's copy is in flight,
// and adds (e * keep factor) v on the tensor cores. The sum l counts the
// probabilities before the mask, as the TPU kernel's does; out = acc / l.
// Under causal the key tiles past the block's last query are skipped, and
// the first tile always holds key 0, so every row's max is finite from the
// first tile on.
template <typename Elem, int DH, bool RAGGED>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_fwd_mma(const Elem* __restrict__ q, const Elem* __restrict__ k,
           const Elem* __restrict__ v, const float* __restrict__ bias,
           Elem* __restrict__ out, int S, int W, int qtiles, float scale,
           const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
           int dropout, int causal, k1::Head hd) {
  using namespace k1;
  constexpr int LS = MmaTile<Elem, DH>::LS, NT = kCols / 8;
  extern __shared__ float4 smem4[];
  Elem* qs = reinterpret_cast<Elem*>(smem4);   // kRows x LS
  Elem* kvs = qs + kRows * LS;                  // 2 stages of (K, V), kCols x LS each

  const int n = blockIdx.x / qtiles, qt = blockIdx.x - n * qtiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int i0 = qt * kRows;
  const Strided rin = window_rows(hd, kIn, n, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = i0 + warp * 16 + (lane >> 2);  // the thread's rows: ra and ra + 8
  const int nk = key_tiles(W, qt, causal);
  K1_PHASE_BEGIN();
  unsigned seed = 0, prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }

  stage_mma<Elem, DH, RAGGED>(qs, q, rin.from(i0), kRows, W - i0, q, hd);
  stage_mma<Elem, DH, RAGGED>(kvs, k, rin, kCols, W, k, hd);
  stage_mma<Elem, DH, RAGGED>(kvs + kCols * LS, v, rin, kCols, W, v, hd);
  cp_async_commit();

  float o[DH / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      Elem* nxt = kvs + ((kt + 1) & 1) * 2 * kCols * LS;
      const int j1 = (kt + 1) * kCols;
      stage_mma<Elem, DH, RAGGED>(nxt, k, rin.from(j1), kCols, W - j1, k, hd);
      stage_mma<Elem, DH, RAGGED>(nxt + kCols * LS, v, rin.from(j1), kCols, W - j1, v, hd);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    K1_PHASE(0);
    const Elem* ks = kvs + (kt & 1) * 2 * kCols * LS;
    const Elem* vs = ks + kCols * LS;

    float s[NT][4] = {};
    gemm_nt<NT, DH>(s, qs + warp * 16 * LS, ks, lane);
    float mx[2] = {m[0], m[1]};
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
                    : s[c][e] * scale;   // a row past the window: computed, never stored
        s[c][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      const float corr = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr;
#pragma unroll
      for (int c = 0; c < DH / 8; ++c) {
        o[c][2 * h] *= corr;
        o[c][2 * h + 1] *= corr;
      }
    }
    const unsigned long long keep =
        dropout ? keep_bits(seed, prow, S, w0, W, ra, kt * kCols, NT, causal, thresh, false,
                            lane)
                : 0ull;
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = __expf(s[c][e] - m[h]);
        l[h] += p;
        s[c][e] = !dropout ? p : (keep >> (4 * c + e)) & 1ull ? p * inv_keep : 0.f;
      }
    K1_PHASE(1);
    gemm_pv<NT, DH>(o, s, vs, lane);
    K1_PHASE(2);
    __syncthreads();
  }
  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_rows<Elem, DH, DH / 8, RAGGED>(out, window_rows(hd, kOut, n, W), o, ra, W, 1.f / la,
                                       1.f / lb, lane, hd);
  K1_PHASE(3);
  K1_PHASE_END(0);
}

// The launch plan's numbers: path 0 (window tiles, float32), 3 (the multi-window
// kernels, bfloat16; k1_multi.cuh) or 1 (long windows), blocks and shared memory. The
// caller's plan must equal them. DH is the staged width, hd the true head dim (RAGGED
// where they differ).
template <typename Elem, int DH, bool RAGGED>
int launch(const Elem* q, const Elem* k, const Elem* v, const float* bias,
           Elem* out, int BH, int S, int W, float scale, const int* seed, int group_rows,
           unsigned thresh, float inv_keep, int dropout, int causal, int path, int blocks,
           int smem_bytes, k1::Head hd, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  if constexpr (std::is_same_v<Elem, __nv_bfloat16>) {
    if (W < k1::kMinWindow)
      return k1::launch_multi_fwd<DH, RAGGED>(q, k, v, bias, out, BH, S, W, scale, seed,
                                              group_rows, thresh, inv_keep, dropout, causal,
                                              path, blocks, smem_bytes, hd, stream);
  } else if (W < k1::kMinWindow) {
    constexpr int QS = TileDims<DH>::QS;
    const size_t per_window =
        sizeof(float) * ((size_t)3 * W * QS + 2 * (size_t)W * (W + 1) + W);
    const int G = k1::windows_per_block(per_window, W, nwin);
    if (G < 1 || path != 0 || blocks != (nwin + G - 1) / G ||
        (size_t)smem_bytes != G * per_window)
      return (int)cudaErrorInvalidValue;
    const auto kernel = k1::spans_rows(hd, G * W) ? k1_fwd_tiles<Elem, DH, RAGGED, true>
                                                  : k1_fwd_tiles<Elem, DH, RAGGED, false>;
    const cudaError_t e = k1::allow_smem(kernel, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, k1::kTileThreads, smem_bytes, stream>>>(
        q, k, v, bias, out, S, W, G, nwin, scale, seed, group_rows, thresh, inv_keep, dropout,
        hd);
    return (int)cudaGetLastError();
  }
  const int qtiles = (W + k1::kRows - 1) / k1::kRows;
  constexpr int smem = k1::fwd_mma_smem<Elem, DH>();
  if (path != 1 || (long long)blocks != (long long)nwin * qtiles || smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = k1::allow_smem(k1_fwd_mma<Elem, DH, RAGGED>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_fwd_mma<Elem, DH, RAGGED><<<blocks, k1::kMmaThreads, smem, stream>>>(
      q, k, v, bias, out, S, W, qtiles, scale, seed, group_rows, thresh, inv_keep, dropout,
      causal, hd);
  return (int)cudaGetLastError();
}

// Switches on the staged width (ops/attention.py::head_width: the least of 16, 32, 64, 96
// and 128 at or above Dh); `copy` must be k1::layout_copy. A library holds one form: the
// native one (Dh the width, copies of 16 bytes) or, kRagged, the ragged one, and refuses
// the other's launches (the forms build in parallel, as libraries of their own).
template <bool kRagged, typename Elem>
int dispatch(const Elem* q, const Elem* k, const Elem* v, const float* bias, Elem* out,
             int BH, int S, int W, int Dh, int H, long long in_pos, long long in_batch,
             long long out_pos, long long out_batch, float scale, const int* seed,
             int group_rows, unsigned thresh, float inv_keep, int dropout, int causal,
             int path, int blocks, int smem_bytes, int copy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (W < 1 || S % W != 0 || S > k1::kMaxRow) return (int)cudaErrorInvalidValue;
  if (group_rows < 1 || BH % group_rows != 0) return (int)cudaErrorInvalidValue;
  k1::Head hd;
  if (!k1::launch_head(BH, S, Dh, copy, (int)sizeof(Elem), H, in_pos, in_batch, out_pos,
                       out_batch, 0, 0, {q, k, v, out}, hd))
    return (int)cudaErrorInvalidValue;
#define K1_FWD(DH_)                                                                       \
  ((Dh == DH_ && copy == 16) == kRagged ? (int)cudaErrorInvalidValue                      \
                          : launch<Elem, DH_, kRagged>(q, k, v, bias, out, BH, S, W, scale, \
                                                       seed, group_rows, thresh, inv_keep,  \
                                                       dropout, causal, path, blocks,       \
                                                       smem_bytes, hd, st))
  if (Dh <= 16) return K1_FWD(16);
  if (Dh <= 32) return K1_FWD(32);
  if (Dh <= 64) return K1_FWD(64);
  if (Dh <= 96) return K1_FWD(96);
  if (Dh <= 128) return K1_FWD(128);
  return (int)cudaErrorInvalidValue;
#undef K1_FWD
}

}  // namespace
