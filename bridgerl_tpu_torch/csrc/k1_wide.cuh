// K1 at head dims past 128: the forward and the backward of
// out = dropout(softmax(q k^T * scale + bias)) v with the head dim in chunks.
//
// Replaces: bridgerl_tpu/ops/pallas/attention.py, _packed_attention_fwd
// (attention.py:143, pallas_call at :149) and _packed_attention_bwd (:164,
// pallas_call at :171), at the head dims the TPU kernel takes whole (it
// blocks over the full Dh, attention.py:120-126) and the kernels of
// k1_fwd.cuh and k1_bwd.cuh are not instantiated at.
//
// Shapes and contract as k1_fwd.cuh and k1_bwd.cuh, with Dh = nc * kChunk,
// nc >= 2 (ops/attention.py pads any Dh past 128 up to a multiple of
// kChunk with zero columns, which add nothing to q k^T or dout v^T, and
// slices the outputs back). Any W up to kMaxRow; the same Philox counters,
// seed groups, causal skips and float32 arithmetic as the long-window path
// (k1_mma.cuh), so the results meet the same rules against the plain
// version.
//
// Design. What a head dim past 128 changes is the size of a row: the
// tensor-core kernels stage whole rows of q, k, v and dout, and at Dh 512 a
// block's rows no longer fit its 227 KB, nor its accumulators the
// registers. So every block owns one kChunk-wide column chunk of its
// outputs (out; dq; dk and dv), the grid being the tensor-core path's times
// nc, and keeps registers and shared memory at the Dh-128 level whatever
// Dh is. The contractions over the head dim (q k^T, and in the backward
// dout v^T) stream chunk by chunk through a double-buffered ring of stages
// in shared memory, each stage one column chunk of the rows a step needs;
// after a tile's last chunk the step that multiplies by the block's own
// chunk (p v; ds k; p_drop^T dout and ds^T q) stages that chunk alone.
// Every block recomputes the logits over the whole head dim, so the work of
// the logits grows nc-fold: this form is right first, and slow at Dh 160
// (padded to 256) and past (PERF.md). The backward is the two-sweep dq
// kernel and the dk / dv kernel of k1_bwd.cuh, chunked the same way: the dq
// kernel's first sweep finds each row's max, normaliser and
// D = rowsum(dp * p), which the blocks of column chunk 0 write to `stats`
// for the dk / dv kernel (3 floats a position, ops/attention.py
// backward_scratch), and its second adds ds k; no atomics, every sum in a
// fixed order, so every output is the same on every launch.
//
// The entry points are packed_attention_wide.cu (float32) and
// packed_attention_wide_bf16.cu, a library a dtype, built in parallel with
// the others (ops/kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "k1_mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kChunk = 128;   // ops/attention.py CHUNK_DIM

template <typename Elem>
struct Wide {
  static constexpr int LS = k1::MmaTile<Elem, kChunk>::LS;
  // a forward stage: kRows q rows and kCols key rows (or kCols value rows)
  static constexpr int kFwdStage = (k1::kRows + k1::kCols) * LS;
  // a backward stage: kRows rows of two tensors and kCols of two more
  static constexpr int kBwdStage = (2 * k1::kRows + 2 * k1::kCols) * LS;
  static constexpr int fwd_smem() { return 2 * kFwdStage * (int)sizeof(Elem); }
  static constexpr int dq_smem() { return 2 * kBwdStage * (int)sizeof(Elem); }
  static constexpr int dkv_smem() {
    return 2 * kBwdStage * (int)sizeof(Elem) + 2 * 3 * k1::kCols * (int)sizeof(float);
  }
};

__device__ __forceinline__ void seed_of(const int* seed_ptr, int group_rows, int row,
                                        int dropout, unsigned& seed, unsigned& prow) {
  seed = 0;
  prow = 0;
  if (dropout) {
    const unsigned grp = (unsigned)row / (unsigned)group_rows;
    seed = (unsigned)__ldg(seed_ptr + grp);
    prow = (unsigned)row - grp * (unsigned)group_rows;
  }
}

// Forward: block (window n, query tile qt, column chunk oc). Step (kt, c) of
// key tile kt stages q's and K's chunk c (c < nc) and adds q_c K_c^T to the
// warp's logits; step (kt, nc) stages V's chunk oc, takes the online
// softmax (as k1_fwd_mma) and adds (e * keep factor) v_oc to the chunk's
// accumulator. out's chunk oc = acc / l.
template <typename Elem>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_fwd_wide(const Elem* __restrict__ q, const Elem* __restrict__ k,
            const Elem* __restrict__ v, const float* __restrict__ bias,
            Elem* __restrict__ out, int S, int W, int nc, int qtiles, float scale,
            const int* __restrict__ seed_ptr, int group_rows, unsigned thresh, float inv_keep,
            int dropout, int causal) {
  using namespace k1;
  constexpr int LS = Wide<Elem>::LS, STAGE = Wide<Elem>::kFwdStage, NT = kCols / 8;
  extern __shared__ float4 smem4[];
  Elem* ring = reinterpret_cast<Elem*>(smem4);   // 2 stages

  const int D = nc * kChunk;
  const int oc = blockIdx.x % nc, b = blockIdx.x / nc;
  const int n = b / qtiles, qt = b - n * qtiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int i0 = qt * kRows;
  const size_t base = (size_t)n * W * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = i0 + warp * 16 + (lane >> 2);
  const int nk = key_tiles(W, qt, causal);
  const int steps = nk * (nc + 1);
  unsigned seed, prow;
  seed_of(seed_ptr, group_rows, row, dropout, seed, prow);

  const auto stage = [&](int it) {
    Elem* dst = ring + (it & 1) * STAGE;
    const int kt = it / (nc + 1), c = it - kt * (nc + 1), j1 = kt * kCols;
    if (c < nc) {
      stage_mma<Elem, kChunk>(dst, q + base + (size_t)i0 * D + c * kChunk, kRows, W - i0, q, D);
      stage_mma<Elem, kChunk>(dst + kRows * LS, k + base + (size_t)j1 * D + c * kChunk, kCols,
                              W - j1, k, D);
    } else {
      stage_mma<Elem, kChunk>(dst, v + base + (size_t)j1 * D + oc * kChunk, kCols, W - j1, v,
                              D);
    }
  };
  stage(0);
  cp_async_commit();

  float o[kChunk / 8][4] = {};
  float s[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Elem* cur = ring + (it & 1) * STAGE;
    const int kt = it / (nc + 1), c = it - kt * (nc + 1);
    if (c == 0) {
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[x][e] = 0.f;
    }
    if (c < nc) {
      gemm_nt<NT, kChunk>(s, cur + warp * 16 * LS, cur + kRows * LS, lane);
    } else {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ra + 8 * (e >> 1), j = kt * kCols + x * 8 + 2 * t + (e & 1);
          float y;
          if (j >= W || (causal && j > i))
            y = -INFINITY;
          else
            y = i < W ? s[x][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j)
                      : s[x][e] * scale;   // a row past the window: computed, never stored
          s[x][e] = y;
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        const float corr = __expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr;
#pragma unroll
        for (int x = 0; x < kChunk / 8; ++x) {
          o[x][2 * h] *= corr;
          o[x][2 * h + 1] *= corr;
        }
      }
      const unsigned long long keep =
          dropout ? keep_bits(seed, prow, S, w0, W, ra, kt * kCols, NT, causal, thresh, false,
                              lane)
                  : 0ull;
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = __expf(s[x][e] - m[h]);
          l[h] += p;
          s[x][e] = !dropout ? p : (keep >> (4 * x + e)) & 1ull ? p * inv_keep : 0.f;
        }
      gemm_pv<NT, kChunk>(o, s, cur, lane);
    }
    __syncthreads();
  }
  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_rows<Elem, kChunk>(out + base + oc * kChunk, o, ra, W, 1.f / la, 1.f / lb, lane, D);
}

// The two-sweep dq kernel, chunked: block (window n, query tile qt, column
// chunk oc). A stage holds the chunk c of q and dout's kRows rows and of a
// (K, V) tile. Sweep 1, steps (kt, c < nc): the logits and dout v^T over the
// chunks; after the last, the keep bits and the online max, l and sum e dp
// (as k1_bwd_mma_dq). Sweep 2 recomputes them, forms ds = p (dp - D) *
// scale and, in a step (kt, nc) that stages K's chunk oc, adds ds k_oc.
template <typename Elem>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_wide_dq(const Elem* __restrict__ q, const Elem* __restrict__ k,
               const Elem* __restrict__ v, const float* __restrict__ bias,
               const Elem* __restrict__ dout, Elem* __restrict__ dq, float* __restrict__ stats,
               int S, int W, int nc, int qtiles, size_t positions, float scale,
               const int* __restrict__ seed_ptr, int group_rows, unsigned thresh,
               float inv_keep, int dropout, int causal) {
  using namespace k1;
  constexpr int LS = Wide<Elem>::LS, STAGE = Wide<Elem>::kBwdStage, NT = kCols / 8;
  extern __shared__ float4 smem4[];
  Elem* ring = reinterpret_cast<Elem*>(smem4);   // 2 stages: q, dout (kRows), K, V (kCols)

  const int D = nc * kChunk;
  const int oc = blockIdx.x % nc, b = blockIdx.x / nc;
  const int n = b / qtiles, qt = b - n * qtiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int i0 = qt * kRows;
  const size_t base = (size_t)n * W * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ra = i0 + warp * 16 + (lane >> 2);
  const int nk = key_tiles(W, qt, causal);
  const int sweep1 = nk * nc, steps = sweep1 + nk * (nc + 1);
  unsigned seed, prow;
  seed_of(seed_ptr, group_rows, row, dropout, seed, prow);

  // step it: (key tile, chunk) of sweep 1, or of sweep 2 where chunk nc is ds k
  const auto step_of = [&](int it, int& kt, int& c) {
    if (it < sweep1) {
      kt = it / nc;
      c = it - kt * nc;
    } else {
      kt = (it - sweep1) / (nc + 1);
      c = it - sweep1 - kt * (nc + 1);
    }
  };
  const auto stage = [&](int it) {
    Elem* dst = ring + (it & 1) * STAGE;
    int kt, c;
    step_of(it, kt, c);
    const int j1 = kt * kCols;
    Elem* kd = dst + 2 * kRows * LS;
    if (c < nc) {
      const size_t col = (size_t)c * kChunk;
      stage_mma<Elem, kChunk>(dst, q + base + (size_t)i0 * D + col, kRows, W - i0, q, D);
      stage_mma<Elem, kChunk>(dst + kRows * LS, dout + base + (size_t)i0 * D + col, kRows,
                              W - i0, dout, D);
      stage_mma<Elem, kChunk>(kd, k + base + (size_t)j1 * D + col, kCols, W - j1, k, D);
      stage_mma<Elem, kChunk>(kd + kCols * LS, v + base + (size_t)j1 * D + col, kCols, W - j1,
                              v, D);
    } else {
      stage_mma<Elem, kChunk>(kd, k + base + (size_t)j1 * D + oc * kChunk, kCols, W - j1, k,
                              D);
    }
  };
  stage(0);
  cp_async_commit();

  float dqa[kChunk / 8][4] = {};
  float s[NT][4], dp[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Elem* cur = ring + (it & 1) * STAGE;
    const Elem* kd = cur + 2 * kRows * LS;
    int kt, c;
    step_of(it, kt, c);
    const bool first = it < sweep1;
    if (it == sweep1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        il[h] = 1.f / quad_sum(l[h]);
        Dr[h] = quad_sum(dn[h]) * il[h];
      }
    }
    if (c == 0) {
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[x][e] = dp[x][e] = 0.f;
    }
    if (c < nc) {
      gemm_nt<NT, kChunk>(s, cur + warp * 16 * LS, kd, lane);
      gemm_nt<NT, kChunk>(dp, cur + (kRows + warp * 16) * LS, kd + kCols * LS, lane);
    }
    if (c == nc - 1) {   // the logits and dp of tile kt are whole
      float mx[2] = {m[0], m[1]};
      const unsigned long long keep =
          dropout ? keep_bits(seed, prow, S, w0, W, ra, kt * kCols, NT, causal, thresh, false,
                              lane)
                  : 0ull;
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ra + 8 * (e >> 1), j = kt * kCols + x * 8 + 2 * t + (e & 1);
          float y;
          if (j >= W || (causal && j > i))
            y = -INFINITY;
          else
            y = i < W ? s[x][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j)
                      : s[x][e] * scale;
          s[x][e] = y;
          if (dropout) dp[x][e] = (keep >> (4 * x + e)) & 1ull ? dp[x][e] * inv_keep : 0.f;
          mx[e >> 1] = fmaxf(mx[e >> 1], y);
        }
      if (first) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = quad_max(mx[h]);
          const float corr = __expf(m[h] - mx[h]);
          m[h] = mx[h];
          l[h] *= corr;
          dn[h] *= corr;
        }
#pragma unroll
        for (int x = 0; x < NT; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[x][e] - m[e >> 1]);
            l[e >> 1] += p;
            dn[e >> 1] = fmaf(p, dp[x][e], dn[e >> 1]);
          }
      } else {
#pragma unroll
        for (int x = 0; x < NT; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float p = __expf(s[x][e] - m[h]) * il[h];
            s[x][e] = p * (dp[x][e] - Dr[h]) * scale;   // ds
          }
      }
    }
    if (c == nc) gemm_pv<NT, kChunk>(dqa, s, kd, lane);
    __syncthreads();
  }
  store_rows<Elem, kChunk>(dq + base + oc * kChunk, dqa, ra, W, 1.f, 1.f, lane, D);
  if (oc == 0 && t == 0) {
    const size_t at = (size_t)row * S + w0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = ra + 8 * h;
      if (i < W) {
        stats[at + i] = m[h];
        stats[positions + at + i] = il[h];
        stats[2 * positions + at + i] = Dr[h];
      }
    }
  }
}

// The dk / dv kernel, chunked: block (window n, key tile kt, column chunk
// oc) owns kRows keys. Per query tile qi, steps (qi, c < nc) stage chunk c
// of the block's k and v rows and of the tile's q and dout rows, and add to
// s^T = k q^T and dp^T = v dout^T; step (qi, nc) stages q's and dout's
// chunk oc with the tile's rows' statistics, forms p_drop^T and ds^T (as
// k1_bwd_mma_dkv) and adds p_drop^T dout_oc to dv and ds^T q_oc to dk.
template <typename Elem>
__global__ void __launch_bounds__(k1::kMmaThreads)
k1_bwd_wide_dkv(const Elem* __restrict__ q, const Elem* __restrict__ k,
                const Elem* __restrict__ v, const float* __restrict__ bias,
                const Elem* __restrict__ dout, Elem* __restrict__ dk, Elem* __restrict__ dv,
                const float* __restrict__ stats, int S, int W, int nc, int ktiles,
                size_t positions, float scale, const int* __restrict__ seed_ptr,
                int group_rows, unsigned thresh, float inv_keep, int dropout, int causal) {
  using namespace k1;
  constexpr int LS = Wide<Elem>::LS, STAGE = Wide<Elem>::kBwdStage, NT = kCols / 8;
  constexpr int NO = kChunk / 8;
  extern __shared__ float4 smem4[];
  Elem* ring = reinterpret_cast<Elem*>(smem4);   // 2 stages: k, v (kRows), q, dout (kCols)
  float* sts = reinterpret_cast<float*>(ring + 2 * STAGE);   // 2 stages of (m, 1/l, D)

  const int D = nc * kChunk;
  const int oc = blockIdx.x % nc, b = blockIdx.x / nc;
  const int n = b / ktiles, kt = b - n * ktiles;
  const int nwr = S / W, row = n / nwr, w0 = (n - row * nwr) * W;
  const int j0 = kt * kRows;
  const size_t base = (size_t)n * W * D;
  const size_t at = (size_t)row * S + w0;       // the window's first position in stats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int ja = j0 + warp * 16 + (lane >> 2);  // the thread's keys: ja and ja + 8
  const int nq = (W + kCols - 1) / kCols, q0 = first_query_tile(kt, causal);
  const int steps = (nq - q0) * (nc + 1);
  unsigned seed, prow;
  seed_of(seed_ptr, group_rows, row, dropout, seed, prow);

  const auto stage = [&](int it) {
    Elem* dst = ring + (it & 1) * STAGE;
    const int qi = q0 + it / (nc + 1), c = it % (nc + 1), i1 = qi * kCols;
    Elem* qd = dst + 2 * kRows * LS;
    const size_t col = (size_t)(c < nc ? c : oc) * kChunk;
    if (c < nc) {
      stage_mma<Elem, kChunk>(dst, k + base + (size_t)j0 * D + col, kRows, W - j0, k, D);
      stage_mma<Elem, kChunk>(dst + kRows * LS, v + base + (size_t)j0 * D + col, kRows, W - j0,
                              v, D);
    } else {
      float* sd = sts + (it & 1) * 3 * kCols;
      for (int e = threadIdx.x; e < 3 * kCols; e += kMmaThreads) {
        const int a = e / kCols, i = e - a * kCols;
        const bool ok = i1 + i < W;
        cp_async4_zfill(sd + a * kCols + i, ok ? stats + a * positions + at + i1 + i : stats,
                        ok);
      }
    }
    stage_mma<Elem, kChunk>(qd, q + base + (size_t)i1 * D + col, kCols, W - i1, q, D);
    stage_mma<Elem, kChunk>(qd + kCols * LS, dout + base + (size_t)i1 * D + col, kCols, W - i1,
                            dout, D);
  };
  // launched as the dq kernel's dependent: nothing it wrote is read before it has ended
  asm volatile("griddepcontrol.wait;" ::: "memory");
  stage(0);
  cp_async_commit();

  float dka[NO][4] = {}, dva[NO][4] = {};
  float s[NT][4], dp[NT][4];
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Elem* cur = ring + (it & 1) * STAGE;
    const Elem* qt_ = cur + 2 * kRows * LS;
    const Elem* ot = qt_ + kCols * LS;
    const int qi = q0 + it / (nc + 1), c = it % (nc + 1);
    if (c == 0) {
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[x][e] = dp[x][e] = 0.f;
    }
    if (c < nc) {
      gemm_nt<NT, kChunk>(s, cur + warp * 16 * LS, qt_, lane);
      gemm_nt<NT, kChunk>(dp, cur + (kRows + warp * 16) * LS, ot, lane);
    } else {
      const float* st = sts + (it & 1) * 3 * kCols;
      const unsigned long long keep =
          dropout ? keep_bits(seed, prow, S, w0, W, ja, qi * kCols, NT, causal, thresh, true,
                              lane)
                  : 0ull;
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int li = x * 8 + 2 * t + (e & 1);      // query, within the tile
          const int i = qi * kCols + li, j = ja + 8 * (e >> 1);
          float p = 0.f, ds = 0.f;
          if (i < W && j < W && !(causal && j > i)) {
            const float y = s[x][e] * scale + __ldg(bias + (size_t)(w0 + i) * S + w0 + j);
            p = __expf(y - st[li]) * st[kCols + li];
            const bool kept = !dropout || ((keep >> (4 * x + e)) & 1ull);
            const float g = !dropout ? dp[x][e] : kept ? dp[x][e] * inv_keep : 0.f;
            ds = p * (g - st[2 * kCols + li]) * scale;
            p = !dropout ? p : kept ? p * inv_keep : 0.f;
          }
          s[x][e] = p;    // p_drop
          dp[x][e] = ds;
        }
      gemm_pv<NT, kChunk>(dva, s, ot, lane);
      gemm_pv<NT, kChunk>(dka, dp, qt_, lane);
    }
    __syncthreads();
  }
  store_rows<Elem, kChunk>(dv + base + oc * kChunk, dva, ja, W, 1.f, 1.f, lane, D);
  store_rows<Elem, kChunk>(dk + base + oc * kChunk, dka, ja, W, 1.f, 1.f, lane, D);
}

// The launch plan's numbers (ops/attention.py::wide_plan); the caller's must
// equal them.
inline bool wide_shape(int BH, int S, int W, int Dh, int group_rows, int dropout,
                       const int* seed) {
  return !(dropout && seed == nullptr) && W >= 1 && S % W == 0 && S <= k1::kMaxRow &&
         group_rows >= 1 && BH % group_rows == 0 && Dh > kChunk && Dh % kChunk == 0;
}

template <typename Elem>
int dispatch_wide_fwd(const Elem* q, const Elem* k, const Elem* v, const float* bias, Elem* out,
                      int BH, int S, int W, int Dh, float scale, const int* seed, int group_rows,
                      unsigned thresh, float inv_keep, int dropout, int causal, int path,
                      int blocks, int smem_bytes, void* stream) {
  if (!wide_shape(BH, S, W, Dh, group_rows, dropout, seed)) return (int)cudaErrorInvalidValue;
  const int nc = Dh / kChunk, qtiles = (W + k1::kRows - 1) / k1::kRows;
  constexpr int smem = Wide<Elem>::fwd_smem();
  if (path != 1 || (long long)blocks != (long long)BH * (S / W) * qtiles * nc ||
      smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = k1::allow_smem(k1_fwd_wide<Elem>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_fwd_wide<Elem><<<blocks, k1::kMmaThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, bias, out, S, W, nc, qtiles, scale, seed, group_rows, thresh, inv_keep, dropout,
      causal);
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch_wide_bwd(const Elem* q, const Elem* k, const Elem* v, const float* bias,
                      const Elem* dout, Elem* dq, Elem* dk, Elem* dv, float* stats, int BH,
                      int S, int W, int Dh, float scale, const int* seed, int group_rows,
                      unsigned thresh, float inv_keep, int dropout, int causal, int path,
                      int blocks, int smem_bytes, int blocks_kv, int smem_kv, void* stream) {
  if (!wide_shape(BH, S, W, Dh, group_rows, dropout, seed) || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nc = Dh / kChunk, tiles = (W + k1::kRows - 1) / k1::kRows;
  constexpr int smem = Wide<Elem>::dq_smem(), smem2 = Wide<Elem>::dkv_smem();
  if (path != 1 || (long long)blocks != (long long)BH * (S / W) * tiles * nc ||
      blocks_kv != blocks || smem_bytes != smem || smem_kv != smem2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t positions = (size_t)BH * S;
  cudaError_t e = k1::allow_smem(k1_bwd_wide_dq<Elem>, smem);
  if (e != cudaSuccess) return (int)e;
  k1_bwd_wide_dq<Elem><<<blocks, k1::kMmaThreads, smem, st>>>(
      q, k, v, bias, dout, dq, stats, S, W, nc, tiles, positions, scale, seed, group_rows, thresh,
      inv_keep, dropout, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = k1::allow_smem(k1_bwd_wide_dkv<Elem>, smem2);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_kv);
  cfg.blockDim = dim3(k1::kMmaThreads);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cfg.attrs = dep;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k1_bwd_wide_dkv<Elem>, q, k, v, bias, dout, dk, dv,
                         (const float*)stats, S, W, nc, tiles, positions, scale, seed,
                         group_rows, thresh, inv_keep, dropout, causal);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
