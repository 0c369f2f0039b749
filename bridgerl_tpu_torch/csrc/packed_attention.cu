// K1 forward: packed-window attention,
// out = dropout(softmax(q k^T * scale + bias)) v, within windows of W
// positions of each packed row.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149, kernel body _attn_kernel at :51).
// The backward is csrc/packed_attention_bwd.cu.
//
// Shapes: q, k, v, out are (BH, S, Dh), contiguous, 16-byte aligned, all
// float32 (entry point packed_attention_fwd) or all bfloat16
// (packed_attention_fwd_bf16); bias is (S, S) float32 in both. Under
// bfloat16, as in the TPU kernel, q, k and v are widened to float32 as they
// are read, the logits, softmax, dropout and p v are float32, and out is
// rounded to bfloat16 once, as it is stored (k1_tiles.cuh). W divides S; query i attends to the keys j of its
// own window (i / W == j / W) with bias[i * S + j] added, and nothing else
// of bias is read. Dh is one of 16, 32, 64, 128 (a template argument). With
// dropout on, element (i, j) of row r (positions in the packed row) is kept
// when Philox word attn_keep_bits(seed, r, i * S + j) < thresh (philox.cuh)
// and is then scaled by inv_keep; the softmax's normaliser sums the
// probabilities before the mask, as the TPU kernel does. seed is read from
// device memory, so drawing it never waits for the card. seed holds one
// value per group of group_rows rows (BH / group_rows groups, the seeds of
// a stacked multi-seed step): row r of group g = r / group_rows draws with
// seed[g] as row r - g * group_rows, so each group gets the mask of a
// launch of its own (philox.cuh); one group is the single-seed launch.
//
// Only the diagonal blocks, and that is exact: the model's bias is -1e9
// across windows, so every across-window probability is expf(s - 1e9 - m),
// which is exactly 0 in f32 for any logit the model can produce; those
// blocks add exactly nothing to the softmax sums or to p v. Computing the
// W x W blocks alone does 1/P of the full row's work (P = S / W windows).
//
// What bounds it on an H100: at the training shape (256, 80, 64), W = 10,
// the function needs 4 * BH * S * W * Dh = 52 MFLOP (0.8 us on the 67
// TFLOP/s float32 cores) and moves 4 * 4 * BH * S * Dh bytes = 21 MB (q, k,
// v read once, out written once: 6.3 us at 3.35 TB/s). That is 2.5 FLOP a
// byte where the float32 cores need about 20 before they, and not memory,
// set the pace: it is bound by bytes. At serving's (2048, 80, 64) the same
// ratio holds at 8x the size. In bfloat16 the bytes halve (3.1 us at the
// training shape) and it stays bound by them.
//
// Design (window tiles): a block of 128 threads takes G = 20 / W
// consecutive windows (2 at W = 10), which are one contiguous span of
// device memory, and copies q, k and v with 16-byte cp.async into padded
// shared rows (k1_tiles.cuh). The grid covers the windows, not the rows
// (1,024 blocks at the training shape, 8,192 at serving b = 4096), so every
// load of the function is in flight at once and no block waits on another.
// While the copies are in flight, one thread per element fetches bias_ij
// and computes the keep factor (0 or 1 / keep) from Philox into shared
// memory, off the logits' chain. (bfloat16 rows are loaded 8 bytes a
// thread, every tensor's loads issued before any is widened into the same
// float32 rows; those loads end before the bias and keep factors start.) Then the block computes:
//   1. the logits in 2 x 2 tiles, one thread per tile: each float4 of q_i
//      and k_j read from shared memory feeds two logits;
//   2. per query row, the f32 softmax with expf(s - m), normalising before
//      dropout: the row keeps e * keep factor and 1 / l;
//   3. out = (p v) / l for two rows at one 16-byte column a thread, written
//      with 16-byte stores that neighbouring threads make to neighbouring
//      addresses.
// The block's phases run one after another (load, logits, softmax, p v,
// store), and the load of the inputs overlaps nothing inside a block: that
// chain, not the bytes, sets the time at the training shape (PERF.md).
// Windows too large for one block's shared memory (W = S up to 219 at
// Dh = 128, the general-bias cases) take the row path below: one block of
// eight warps per window stages K and V (rows of Dh + 1 floats), one warp
// per query row, lane per key.
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
k1_fwd_tiles(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, const float* __restrict__ bias,
             Elem* __restrict__ out, int S, int W, int G, int nwin, float scale,
             const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
             int dropout) {
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

  const size_t gbase = (size_t)n0 * W * DH;
  {
    float* const dst[3] = {qs, ks, vs};
    const Elem* const src[3] = {q + gbase, k + gbase, v + gbase};
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
    Elem* o = out + gbase + (size_t)r0 * DH + 4 * c;
    const float s0 = il[r0];
    k1::store4(o, make_float4(a0.x * s0, a0.y * s0, a0.z * s0, a0.w * s0));
    if (i0 + 1 < W) {
      const float s1 = il[r1];
      k1::store4(o + DH, make_float4(a1.x * s1, a1.y * s1, a1.z * s1, a1.w * s1));
    }
  }
}

// Row path, for windows too large to tile: one block per window, K and V of
// the window in shared memory with a padded row stride of Dh + 1 (32 lanes
// reading 32 different keys hit 32 different banks); each warp takes query
// rows i = warp, warp + 8, ..., holds q_i in registers, computes its W logits
// lane-per-key, takes the f32 softmax with expf of s - max through warp
// shuffles, and accumulates p v lane-per-output-dim.
template <typename Elem, int DH>
__global__ void __launch_bounds__(kRowWarps * 32)
k1_fwd_rows(const Elem* __restrict__ q, const Elem* __restrict__ k,
            const Elem* __restrict__ v, const float* __restrict__ bias,
            Elem* __restrict__ out, int S, int W, float scale,
            const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
            int dropout) {
  extern __shared__ float smem[];
  constexpr int KS = DH + 1;                  // padded K row stride
  constexpr int DPL = (DH + 31) / 32;         // output dims per lane
  float* ks = smem;                           // W * KS
  float* vs = ks + W * KS;                    // W * DH
  float* ps = vs + W * DH;                    // kRowWarps * W

  const int n = blockIdx.x, nwr = S / W;
  const int w0 = (n % nwr) * W;
  const unsigned grp = (unsigned)(n / nwr) / (unsigned)group_rows;  // seed group
  const unsigned row = (unsigned)(n / nwr) - grp * (unsigned)group_rows;
  const size_t base = (size_t)n * W * DH;
  const unsigned seed = dropout ? (unsigned)seed_ptr[grp] : 0u;
  const Elem* qr = q + base;
  const Elem* kr = k + base;
  const Elem* vr = v + base;
  Elem* orow = out + base;

  for (int i = threadIdx.x; i < W * DH; i += blockDim.x) {
    const int j = i / DH, d = i % DH;
    ks[j * KS + d] = k1::to_float(kr[i]);
    vs[i] = k1::to_float(vr[i]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * W;
  for (int i = warp; i < W; i += kRowWarps) {
    float qv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) qv[d] = k1::to_float(qr[i * DH + d]);

    float m = -INFINITY;
    for (int j = lane; j < W; j += 32) {
      const float* kj = ks + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc = fmaf(qv[d], kj[d], acc);
      const float s = acc * scale + bias[(size_t)(w0 + i) * S + w0 + j];
      p[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    float l = 0.f;
    for (int j = lane; j < W; j += 32) {
      const float e = expf(p[j] - m);
      l += e;
      const unsigned pos = (unsigned)((w0 + i) * S + w0 + j);
      p[j] = !dropout ? e : attn_keep_bits(seed, row, pos) < thresh ? e * inv_keep : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    __syncwarp();

    float acc[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[c] = 0.f;
    for (int j = 0; j < W; ++j) {
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
      if (d < DH) orow[i * DH + d] = k1::from_float<Elem>(acc[c] * inv);
    }
    __syncwarp();  // p is rewritten by this warp's next query row
  }
}

template <typename Elem, int DH>
int launch(const Elem* q, const Elem* k, const Elem* v, const float* bias,
           Elem* out, int BH, int S, int W, float scale, const int* seed, int group_rows,
           unsigned thresh, float inv_keep, int dropout, cudaStream_t stream) {
  const int nwin = BH * (S / W);
  constexpr int QS = TileDims<DH>::QS;
  const size_t per_window =
      sizeof(float) * ((size_t)3 * W * QS + 2 * (size_t)W * (W + 1) + W);
  const int G = k1::windows_per_block(per_window, W, nwin);
  if (G > 0) {
    const size_t smem = G * per_window;
    const cudaError_t e = k1::allow_smem(k1_fwd_tiles<Elem, DH>, smem);
    if (e != cudaSuccess) return (int)e;
    k1_fwd_tiles<Elem, DH><<<(nwin + G - 1) / G, k1::kTileThreads, smem, stream>>>(
        q, k, v, bias, out, S, W, G, nwin, scale, seed, group_rows, thresh, inv_keep, dropout);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((size_t)W * (2 * DH + 1) + kRowWarps * W);
  if (smem > (size_t)k1::kSmemLimit) return (int)cudaErrorInvalidValue;
  const cudaError_t e = k1::allow_smem(k1_fwd_rows<Elem, DH>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_fwd_rows<Elem, DH><<<nwin, kRowWarps * 32, smem, stream>>>(
      q, k, v, bias, out, S, W, scale, seed, group_rows, thresh, inv_keep, dropout);
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch(const Elem* q, const Elem* k, const Elem* v, const float* bias, Elem* out, int BH, int S,
             int W, int Dh, float scale, const int* seed, int group_rows,
             unsigned thresh, float inv_keep,
             int dropout, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dropout && seed == nullptr) return (int)cudaErrorInvalidValue;
  if (W < 1 || S % W != 0) return (int)cudaErrorInvalidValue;
  if (group_rows < 1 || BH % group_rows != 0) return (int)cudaErrorInvalidValue;
#define K1_FWD(DH_) \
  launch<Elem, DH_>(q, k, v, bias, out, BH, S, W, scale, seed, group_rows, \
                    thresh, inv_keep, dropout, st)
  switch (Dh) {
    case 16: return K1_FWD(16);
    case 32: return K1_FWD(32);
    case 64: return K1_FWD(64);
    case 128: return K1_FWD(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_FWD
}

}  // namespace

extern "C" int packed_attention_fwd(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, int BH, int S, int W, int Dh,
                                    float scale, const int* seed, int group_rows,
                                    unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  return dispatch(q, k, v, bias, out, BH, S, W, Dh, scale, seed, group_rows,
                  thresh, inv_keep, dropout,
                  stream);
}

extern "C" int packed_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const float* bias,
                                         __nv_bfloat16* out, int BH, int S, int W, int Dh,
                                         float scale, const int* seed, int group_rows,
                                         unsigned thresh, float inv_keep,
                                         int dropout, void* stream) {
  return dispatch(q, k, v, bias, out, BH, S, W, Dh, scale, seed, group_rows,
                  thresh, inv_keep, dropout,
                  stream);
}
